// fastxpack — native FASTQ/FASTA(.gz) streaming parser + 2-bit batch packer.
//
// The host-side counterpart of the reference's FASTXreader + SequenceUtils
// host path (reference src/fastxutils/FastXReader.h:118-478 chunked zlib
// reader; src/utils/SequenceUtils.h:86-160 2-bit encoder): instead of
// materializing per-kmer strings, it emits fixed-shape device batches —
// uint32 words of 16 packed bases (LSB-first, A=00 C=01 G=10 T=11) plus a
// per-window validity bitmask — exactly the layout the Pallas/XLA window
// extractor consumes (see tsxcount_tpu/io/packer.py, the python reference
// implementation this must stay bit-identical to).
//
// Batch semantics (must match ReadPacker):
//   * every read starts on a 16-base word boundary;
//   * reads shorter than k are skipped (reference testExecution.h:18-19);
//   * reads longer than remaining capacity split with k-1 base overlap;
//   * window validity is INTERVAL-coded: the batch buffer is
//     [words | interval starts | interval ends] — sorted disjoint
//     [start, end) runs of valid window positions (fully inside one read
//     segment and, under drop policy, N-free); unused interval slots hold
//     0xFFFFFFFF.  A batch whose interval budget fills flushes early,
//     continuing the read in the next batch with the k-1 overlap;
//   * n_policy: 0 = drop (windows containing N masked),
//               1 = random (N replaced by a seeded random base — the
//               reference's nondeterministic behavior, SequenceUtils.h:126-137,
//               made deterministic with an explicit seed).
//
// Built at first use by tsxcount_tpu/io/native.py (g++ -O3 -march=native
// -std=c++17 -shared -fPIC ... -lz) into _native/build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <utility>
#include <vector>

#include <zlib.h>

namespace {

constexpr int kBasesPerWord = 16;

// ASCII -> 2-bit code; 255 = invalid (N etc.)
struct CodeLut {
  uint8_t lut[256];
  CodeLut() {
    memset(lut, 255, sizeof(lut));
    lut['A'] = lut['a'] = 0;
    lut['C'] = lut['c'] = 1;
    lut['G'] = lut['g'] = 2;
    lut['T'] = lut['t'] = 3;
  }
};
const CodeLut g_lut;

// splitmix64 — small deterministic rng for n_policy=random
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed + 0x9E3779B97F4A7C15ULL) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
};

struct Handle {
  gzFile file = nullptr;
  int k = 0;
  int n_policy = 0;
  bool collapse = true;  // homopolymer run-length collapse (see encode_read)
  Rng rng{0};
  bool is_fasta = false;
  bool eof = false;
  std::string error;

  // byte-range parsing (plain files only): this handle owns records whose
  // header byte offset is in (range_skip, range_end]; range_end < 0 = to
  // EOF.  Ownership rule matches the reference-style chunked FASTQ
  // discipline: the reader seeked to offset s discards the line containing
  // s (a record starting exactly at s belongs to the previous chunk, whose
  // stop condition is offset > its end).
  int64_t range_end = -1;

  // line buffer
  std::vector<char> buf;
  size_t buf_pos = 0, buf_len = 0;
  int64_t consumed_total = 0;  // bytes pulled from the file so far

  // lines pushed back during range resync: (text, byte offset)
  std::deque<std::pair<std::string, int64_t>> pending;

  // current read being packed: 2-bit codes + validity run lengths
  std::vector<uint8_t> codes;
  std::vector<uint8_t> isn;  // 1 = invalid (N under drop policy)
  std::vector<int32_t> run;  // run[i] = consecutive non-N bases from i
  size_t start = 0;          // next unpacked offset within codes
  bool have_read = false;
  std::string fasta_carry;   // next FASTA header already consumed
  int64_t fasta_carry_off = 0;

  // stats (mirrors PackStats)
  int64_t reads = 0, reads_skipped = 0, bases = 0, n_bases = 0, windows = 0;
  int64_t packed_words = 0;  // uint32 words actually emitted across batches
  int64_t hp_bonus[4] = {0, 0, 0, 0};  // elided all-X windows per base code

  int64_t cur_offset() const {
    return consumed_total - (int64_t)(buf_len - buf_pos);
  }

  bool fill() {
    if (buf.empty()) buf.resize(1 << 20);
    int n = gzread(file, buf.data(), (unsigned)buf.size());
    if (n < 0) {
      int errnum = 0;
      error = gzerror(file, &errnum);
      return false;
    }
    buf_pos = 0;
    buf_len = (size_t)n;
    consumed_total += n;
    return n > 0;
  }

  // read one line (without newline) into out; false on EOF
  bool getline(std::string &out) {
    out.clear();
    for (;;) {
      if (buf_pos >= buf_len) {
        if (!fill()) return !out.empty();
      }
      char *base = buf.data() + buf_pos;
      size_t avail = buf_len - buf_pos;
      char *nl = (char *)memchr(base, '\n', avail);
      if (nl) {
        size_t n = (size_t)(nl - base);
        out.append(base, n);
        buf_pos += n + 1;
        if (!out.empty() && out.back() == '\r') out.pop_back();
        return true;
      }
      out.append(base, avail);
      buf_pos = buf_len;
    }
  }

  // getline with the line's start offset, honoring resync push-backs
  bool next_line(std::string &out, int64_t *off) {
    if (!pending.empty()) {
      out = std::move(pending.front().first);
      *off = pending.front().second;
      pending.pop_front();
      return true;
    }
    *off = cur_offset();
    return getline(out);
  }

  // Position the parser at the first record owned by (skip, range_end].
  // Called once after seeking to `skip`: discards the line containing the
  // seek point, then scans to a record boundary (FASTA: a '>' line; FASTQ:
  // a line L starting '@' with L+2 starting '+', which disambiguates
  // '@'-leading quality lines because sequence lines never start with '+').
  bool resync() {
    std::string line;
    int64_t off;
    if (!getline(line)) {  // partial line at the seek point
      eof = true;
      return true;
    }
    if (is_fasta) {
      for (;;) {
        off = cur_offset();
        if (!getline(line)) {
          eof = true;
          return true;
        }
        if (!line.empty() && line[0] == '>') {
          if (range_end >= 0 && off > range_end) {
            eof = true;
            return true;
          }
          pending.emplace_back(std::move(line), off);
          return true;
        }
      }
    }
    // FASTQ: keep a 3-line lookahead window
    std::deque<std::pair<std::string, int64_t>> win;
    for (;;) {
      while (win.size() < 3) {
        off = cur_offset();
        if (!getline(line)) {
          eof = true;
          return true;
        }
        win.emplace_back(std::move(line), off);
      }
      if (!win[0].first.empty() && win[0].first[0] == '@' &&
          !win[2].first.empty() && win[2].first[0] == '+') {
        if (range_end >= 0 && win[0].second > range_end) {
          eof = true;
          return true;
        }
        pending = std::move(win);
        return true;
      }
      win.pop_front();
    }
  }

  void encode_read(const std::string &seq) {
    size_t n = seq.size();
    reads++;
    bases += (int64_t)n;
    codes.resize(n);
    isn.resize(n);
    int64_t local_n = 0;
    for (size_t i = 0; i < n; ++i) {
      uint8_t c = g_lut.lut[(uint8_t)seq[i]];
      if (c == 255) {
        local_n++;
        isn[i] = (n_policy == 1) ? 0 : 1;
        codes[i] = (n_policy == 1) ? (uint8_t)(rng.next() & 3) : 0;
      } else {
        isn[i] = 0;
        codes[i] = c;
      }
    }
    n_bases += local_n;
    if (n < (size_t)k) {  // skip on ORIGINAL length (python-packer parity)
      reads_skipped++;
      have_read = false;
      return;
    }
    // Homopolymer collapse: splice maximal valid single-base runs longer
    // than keep = 2k-2 down to keep bases, crediting the elided all-X
    // windows to hp_bonus (exactly L - keep per run).  Window contents and
    // validity of every surviving position are preserved — see the proof
    // in tsxcount_tpu/io/packer.py collapse_homopolymers, which this must
    // stay bit-identical to.
    if (collapse && k >= 2) {
      size_t keep = (size_t)(2 * k - 2);
      size_t w = 0, i = 0;
      while (i < n) {
        size_t j = i + 1;
        if (!isn[i])
          while (j < n && !isn[j] && codes[j] == codes[i]) ++j;
        size_t L = j - i, keepL = L;
        if (!isn[i] && L > keep) {
          keepL = keep;
          hp_bonus[codes[i]] += (int64_t)(L - keep);
        }
        if (w != i)
          for (size_t t = 0; t < keepL; ++t) {
            codes[w + t] = codes[i + t];
            isn[w + t] = isn[i + t];
          }
        w += keepL;
        i = j;
      }
      codes.resize(w);
      isn.resize(w);
      n = w;
    }
    // validity runs: run[i] = consecutive valid bases from i
    run.resize(n + 1);
    run[n] = 0;
    for (size_t i = n; i-- > 0;) run[i] = isn[i] ? 0 : run[i + 1] + 1;
    start = 0;
    have_read = true;
  }

  // parse the next record into codes/run; false on EOF, range end, or error
  bool next_record() {
    std::string line, seq;
    int64_t off;
    if (is_fasta) {
      bool have_line;
      if (!fasta_carry.empty()) {
        line = std::move(fasta_carry);
        off = fasta_carry_off;
        fasta_carry.clear();
        have_line = true;
      } else {
        have_line = next_line(line, &off);
      }
      if (have_line) {
        if (line.empty() || line[0] != '>') {
          error = "malformed FASTA header";
          return false;
        }
        if (range_end >= 0 && off > range_end) return false;  // next chunk's
        for (;;) {
          std::string l2;
          int64_t off2;
          if (!next_line(l2, &off2)) break;
          if (!l2.empty() && l2[0] == '>') {
            fasta_carry = std::move(l2);
            fasta_carry_off = off2;
            break;
          }
          seq += l2;
        }
        encode_read(seq);
        return true;
      }
      return false;
    }
    // FASTQ: 4-line records
    if (!next_line(line, &off)) return false;
    if (line.empty()) return false;
    if (line[0] != '@') {
      error = "malformed FASTQ record (missing @)";
      return false;
    }
    if (range_end >= 0 && off > range_end) return false;  // next chunk's
    if (!next_line(seq, &off)) {
      error = "truncated FASTQ record";
      return false;
    }
    std::string plus, qual;
    if (!next_line(plus, &off) || plus.empty() || plus[0] != '+' ||
        !next_line(qual, &off)) {
      error = "truncated FASTQ record";
      return false;
    }
    encode_read(seq);
    return true;
  }
};

// Pack codes[start, start+seg_len) at word w0 and emit valid-window runs
// as intervals.  Returns the number of bases actually placed: seg_len
// normally, less if the interval budget truncated the segment mid-read
// (the unplaced windows stay with the read's continuation), 0 if nothing
// fits (caller flushes the batch and retries).  Must stay bit-identical
// to ReadPacker._place_segment.
size_t place_segment(Handle *h, uint32_t *words, uint32_t *iv_s,
                     uint32_t *iv_e, int64_t max_ivs, int64_t *n_ivs,
                     int64_t w0, size_t seg_len) {
  const uint8_t *codes = h->codes.data() + h->start;
  const int32_t *run = h->run.data() + h->start;
  const int k = h->k;
  int64_t n_win = (int64_t)seg_len - k + 1;
  int64_t base = w0 * kBasesPerWord;

  // maximal runs of valid window starts, truncated at the interval budget
  int64_t placed_win = n_win;
  int64_t run_start = -1;
  int64_t emitted_windows = 0;
  bool truncated = false;
  for (int64_t p = 0; p < n_win; ++p) {
    bool ok = run[p] >= k;
    if (ok && run_start < 0) {
      if (*n_ivs >= max_ivs) {
        truncated = true;
        placed_win = p;
        break;
      }
      run_start = p;
      iv_s[*n_ivs] = (uint32_t)(base + p);
    } else if (!ok && run_start >= 0) {
      iv_e[(*n_ivs)++] = (uint32_t)(base + p);
      emitted_windows += p - run_start;
      run_start = -1;
    }
  }
  if (run_start >= 0) {
    iv_e[(*n_ivs)++] = (uint32_t)(base + placed_win);
    emitted_windows += placed_win - run_start;
  }
  size_t placed =
      truncated ? (placed_win > 0 ? (size_t)(placed_win + k - 1) : 0)
                : seg_len;
  if (placed == 0) return 0;
  h->windows += emitted_windows;

  // pack exactly `placed` bases (tail bits of the last word stay zero)
  int64_t w = w0;
  size_t i = 0;
  for (; i + kBasesPerWord <= placed; i += kBasesPerWord, ++w) {
    uint32_t v = 0;
    for (int j = kBasesPerWord - 1; j >= 0; --j)
      v = (v << 2) | codes[i + (size_t)j];
    words[w] = v;
  }
  if (i < placed) {
    uint32_t v = 0;
    for (size_t j = placed; j-- > i;) v = (v << 2) | codes[j];
    words[w] = v;
  }
  return placed;
}

}  // namespace

extern "C" {

// Open a byte range [byte_start, byte_end) of the file; the handle yields
// exactly the records owned by that range (see Handle::range_end ownership
// rule), so N readers on a partition of [0, filesize) together parse every
// record exactly once — the chunked-reader analog of the reference's
// FASTXreader task loop (reference src/mains/main.cpp:132-218), and the
// multi-host input-splitting primitive.  byte_end < 0 = to EOF.  Ranges
// with byte_start > 0 or byte_end >= 0 require an UNCOMPRESSED file
// (gzip streams cannot seek); such opens on gzip data return nullptr.
void *fxp_open_range(const char *path, int k, int n_policy, uint64_t seed,
                     int64_t byte_start, int64_t byte_end, int collapse) {
  Handle *h = new Handle();
  h->k = k;
  h->n_policy = n_policy;
  h->collapse = collapse != 0;
  h->rng = Rng(seed);
  h->range_end = byte_end;
  h->file = gzopen(path, "rb");
  if (!h->file) {
    delete h;
    return nullptr;
  }
  gzbuffer(h->file, 1 << 20);
  int first = gzgetc(h->file);
  if (first < 0) {
    h->eof = true;
    return h;
  }
  gzungetc(first, h->file);
  h->is_fasta = (first == '>');
  bool ranged = byte_start > 0 || byte_end >= 0;
  if (ranged && !gzdirect(h->file)) {  // compressed: cannot seek
    gzclose(h->file);
    delete h;
    return nullptr;
  }
  if (byte_start > 0) {
    if (gzseek(h->file, (z_off_t)byte_start, SEEK_SET) < 0) {
      gzclose(h->file);
      delete h;
      return nullptr;
    }
    h->consumed_total = byte_start;
    h->buf_pos = h->buf_len = 0;
    h->resync();
  }
  return h;
}

void *fxp_open(const char *path, int k, int n_policy, uint64_t seed) {
  return fxp_open_range(path, k, n_policy, seed, 0, -1, 0);
}

// Fills one batch buffer laid out as [words | iv starts | iv ends]:
// total_words uint32 of packed bases (zeroed here) followed by
// 2*max_intervals uint32 of validity intervals (set to 0xFFFFFFFF here).
// Returns 1 if more data may follow, 0 on EOF (batch may still hold data),
// -1 on parse error.
int fxp_next_batch(void *hv, uint32_t *buf, int64_t total_words,
                   int64_t capacity_words, int64_t max_intervals,
                   int64_t *n_valid, int64_t *n_bases_out) {
  Handle *h = (Handle *)hv;
  uint32_t *words = buf;
  uint32_t *iv_s = buf + total_words;
  uint32_t *iv_e = iv_s + max_intervals;
  memset(words, 0, (size_t)total_words * sizeof(uint32_t));
  memset(iv_s, 0xFF, (size_t)(2 * max_intervals) * sizeof(uint32_t));
  int64_t cur_word = 0;
  int64_t n_ivs = 0;
  int64_t batch_bases = 0;
  int64_t windows_before = h->windows;
  const int k = h->k;

  for (;;) {
    if (!h->have_read) {
      if (h->eof) break;
      if (!h->next_record()) {
        if (!h->error.empty()) return -1;
        h->eof = true;
        break;
      }
      continue;  // may have been skipped (len < k)
    }
    size_t remaining = h->codes.size() - h->start;
    if (remaining < (size_t)k) {
      h->have_read = false;
      continue;
    }
    int64_t avail_bases = (capacity_words - cur_word) * kBasesPerWord;
    if (avail_bases < k) break;  // batch full (words)
    size_t seg_len =
        remaining < (size_t)avail_bases ? remaining : (size_t)avail_bases;
    size_t placed = place_segment(h, words, iv_s, iv_e, max_intervals,
                                  &n_ivs, cur_word, seg_len);
    if (placed == 0) break;  // batch full (interval budget): early flush
    batch_bases += (int64_t)placed;
    cur_word += (int64_t)((placed + kBasesPerWord - 1) / kBasesPerWord);
    if (h->start + placed >= h->codes.size()) {
      h->have_read = false;
    } else {
      h->start += placed - (size_t)(k - 1);
    }
  }
  *n_valid = h->windows - windows_before;
  *n_bases_out = batch_bases;
  h->packed_words += cur_word;
  return h->eof && !h->have_read ? 0 : 1;
}

// Total uint32 words emitted so far (batch-fill accounting: drives batch
// sizing and H2D/HBM footprint estimates).
int64_t fxp_packed_words(void *hv) {
  Handle *h = (Handle *)hv;
  return h->packed_words;
}

void fxp_stats(void *hv, int64_t *reads, int64_t *skipped, int64_t *bases,
               int64_t *n_bases, int64_t *windows) {
  Handle *h = (Handle *)hv;
  *reads = h->reads;
  *skipped = h->reads_skipped;
  *bases = h->bases;
  *n_bases = h->n_bases;
  *windows = h->windows;
}

// Per-base-code counts of homopolymer windows elided by the collapse
// (exact; the caller merges them into the store once at finish).
void fxp_hp_bonus(void *hv, int64_t *out4) {
  Handle *h = (Handle *)hv;
  for (int c = 0; c < 4; ++c) out4[c] = h->hp_bonus[c];
}

const char *fxp_error(void *hv) {
  Handle *h = (Handle *)hv;
  return h->error.c_str();
}

void fxp_close(void *hv) {
  Handle *h = (Handle *)hv;
  if (h->file) gzclose(h->file);
  delete h;
}

}  // extern "C"
