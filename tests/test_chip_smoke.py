"""chip_smoke.py's host oracle against tools/make_golden.py on tiny files.

The oracle is what every GPU phase of chip_smoke.py is checked against, so
it is itself checked here against the independent golden-count generator:
window totals, distinct keys, sampled present counts (polyA first) and
absent keys, on reads with N bases, short reads and polyA tails."""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
import make_golden  # noqa: E402


@pytest.fixture(scope="module")
def tiny_fastq(tmp_path_factory):
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("smoke") / "tiny.fastq"
    with open(path, "w") as f:
        for i in range(60):
            n = int(rng.integers(20, 400))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
            if i % 7 == 3:  # N bases break windows
                pos = rng.integers(0, n, size=3)
                seq = "".join("N" if j in pos else ch
                              for j, ch in enumerate(seq))
            seq += "A" * int(rng.integers(0, 200))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path


@pytest.mark.parametrize("k", [14, 31, 127])
def test_oracle_matches_make_golden(tiny_fastq, k):
    want = make_golden.count_file(str(tiny_fastq), k)
    o = chip_smoke.host_oracle(tiny_fastq, k, n_present=300, n_absent=50)
    assert o.n_windows == sum(want.values())
    assert o.distinct == len(want)
    assert o.present[0] == "A" * k
    assert len(o.present) == min(300, len(want)) + 1
    assert o.present_counts == [want[s] for s in o.present]
    assert len(o.absent) == 50
    assert not any(s in want for s in o.absent)
    assert all(len(s) == k for s in o.present + o.absent)
