// Native host data plane for deepchopper_tpu_torch (a copy of the JAX
// package's deepchopper_tpu/native/host_ops.cpp).
//
// C++ equivalents of the reference's Rust core hot loops
// (reference: src/output/writefq.rs, src/smooth/utils.rs:48-97,
// src/fq_encode/triat.rs:102-151, src/bin/predict.rs:271-297):
//   * FASTQ buffer indexing (memchr newline scan -> record offset table)
//   * fused base-tokenize + phred-qual encode (single pass over the read)
//   * batched sliding-window majority vote
//   * BGZF block compression with an internal thread pool
//
// Exposed via a flat extern "C" API consumed through ctypes
// (deepchopper_tpu_torch/native/__init__.py). All functions are thread-safe and
// hold no global state except the lazily-created compression pool.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// FASTQ indexing
// ---------------------------------------------------------------------------

// Scan a FASTQ text buffer and emit per-record spans:
//   out[8*i + 0..7] = id_off, id_len, seq_off, seq_len, qual_off, qual_len,
//                     desc_off, desc_len  (desc == text after first space; -1/-0 when none)
// Record i's id span EXCLUDES the leading '@'. Lines may end with \n or \r\n.
// `consumed` receives the buffer offset after the last complete record, so a
// streaming caller can carry the tail into the next chunk (a record truncated
// by the buffer end is NOT an error — it is simply not consumed).
// Returns the number of complete records indexed, or a negative error code:
//   -1 malformed header (no '@'), -2 malformed '+' separator,
//   -4 seq/qual length mismatch.
// `final_chunk` == 0 means more data may follow: a record whose quality line
// is not newline-terminated inside the buffer is treated as truncated (it may
// continue in the next chunk) and left unconsumed.
long long fq_index(const uint8_t* buf, long long n, long long max_records,
                   long long* out, long long* consumed, int final_chunk) {
  long long pos = 0, rec = 0;
  *consumed = 0;
  auto line_end = [&](long long start, long long* content_len) -> long long {
    const uint8_t* nl =
        static_cast<const uint8_t*>(memchr(buf + start, '\n', n - start));
    long long end = nl ? (nl - buf) : n;
    long long len = end - start;
    if (len > 0 && buf[end - 1] == '\r') len--;
    *content_len = len;
    return nl ? end + 1 : n;  // position after the newline
  };
  while (pos < n && rec < max_records) {
    // Skip blank lines between records.
    while (pos < n && (buf[pos] == '\n' || buf[pos] == '\r')) pos++;
    if (pos >= n) break;
    if (buf[pos] != '@') return -1;
    long long id_line = pos + 1, id_len;
    pos = line_end(id_line, &id_len);
    if (pos >= n) break;  // truncated: leave for the next chunk
    // Split id vs description at the first space/tab.
    long long name_len = id_len, desc_off = -1, desc_len = 0;
    for (long long k = 0; k < id_len; ++k) {
      if (buf[id_line + k] == ' ' || buf[id_line + k] == '\t') {
        name_len = k;
        desc_off = id_line + k + 1;
        desc_len = id_len - k - 1;
        break;
      }
    }
    long long seq_off = pos, seq_len;
    pos = line_end(seq_off, &seq_len);
    if (pos >= n) break;
    if (buf[pos] != '+') return -2;
    long long plus_len;
    pos = line_end(pos, &plus_len);
    if (pos >= n) break;
    long long qual_off = pos, qual_len;
    pos = line_end(qual_off, &qual_len);
    // Unterminated qual line: may continue in the next chunk unless final.
    if (pos >= n && buf[n - 1] != '\n' && !final_chunk) break;
    if (qual_len < seq_len && pos >= n && !final_chunk) break;
    if (qual_len != seq_len) return -4;
    out[8 * rec + 0] = id_line;
    out[8 * rec + 1] = name_len;
    out[8 * rec + 2] = seq_off;
    out[8 * rec + 3] = seq_len;
    out[8 * rec + 4] = qual_off;
    out[8 * rec + 5] = qual_len;
    out[8 * rec + 6] = desc_off;
    out[8 * rec + 7] = desc_len;
    rec++;
    *consumed = pos;
  }
  return rec;
}

// ---------------------------------------------------------------------------
// Fused tokenize + qual encode
// ---------------------------------------------------------------------------

// Base -> token id LUT (reference vocabulary: specials 0-6, A=7 C=8 G=9 T=10
// N=11, unknown -> UNK=6; U tokenizes as T — matches ops.sequence._TOKEN_LUT
// exactly (reference: src/smooth/utils.rs:6-46, tokenizer char vocab).
static int32_t base_token(uint8_t c) {
  switch (c & 0xDF) {  // uppercase fold for ASCII letters
    case 'A': return 7;
    case 'C': return 8;
    case 'G': return 9;
    case 'T': return 10;
    case 'U': return 10;
    case 'N': return 11;
    default: return 6;
  }
}

// seq/qual -> token ids + integer phred scores in one pass
// (reference: src/fq_encode/triat.rs:102-151). qual_out may be null.
void encode_read(const uint8_t* seq, const uint8_t* qual, long long n,
                 int32_t* ids_out, int32_t* qual_out, int qual_offset) {
  for (long long i = 0; i < n; ++i) ids_out[i] = base_token(seq[i]);
  if (qual_out) {
    for (long long i = 0; i < n; ++i)
      qual_out[i] = static_cast<int32_t>(qual[i]) - qual_offset;
  }
}

// Normalize one base like the Python LUT (ops/sequence._build_normalize_lut):
// uppercase fold, U/u -> T, anything else non-ACGT -> N.
static uint8_t norm_base(uint8_t c) {
  uint8_t u = c & 0xDF;
  if (u == 'A' || u == 'C' || u == 'G' || u == 'T') return u;
  if (u == 'U') return 'T';
  return 'N';
}

// Normalize bases in place (reference: `normalize_seq`).
void normalize_seq_inplace(uint8_t* seq, long long n) {
  for (long long i = 0; i < n; ++i) seq[i] = norm_base(seq[i]);
}

// normalize-then-tokenize in one step: matches the Python pipeline's
// normalize_seq (U->T, other->N) followed by the char-tokenizer LUT
// (ops/sequence.py _NORM_LUT + _TOKEN_LUT), so A=7 C=8 G=9 T=U=10, else N=11.
static int8_t norm_token(uint8_t c) {
  switch (c & 0xDF) {  // uppercase fold for ASCII letters
    case 'A': return 7;
    case 'C': return 8;
    case 'G': return 9;
    case 'T': return 10;
    case 'U': return 10;
    default: return 11;
  }
}

// Batched encode of FASTQ record spans straight into one padded (b, width)
// device-feed batch — the whole-chunk replacement for per-read Python
// encode_read (hot path of predict; reference counterpart is the HF `.map`
// tokenize stage, deepchopper/models/llm/tokenizer.py:121-142).
//
//   spans: (n, 8) table from fq_index over `buf`
//   rows:  b indices into spans selecting this batch's reads
// For read i with seq length L: t = min(L, max_len - 1, width - 1);
//   ids[i, :t]  = norm_token(seq), ids[i, t] = sep_token, rest pad_token
//   quals[i, :t] = clamp(qual - qual_offset, 0, 255), rest 0
//   lengths[i]  = t + 1 (valid tokens incl. SEP — the contract of
//                 data/bucketing.pad_batch)
void encode_spans_batch(const uint8_t* buf, const int64_t* spans,
                        const int64_t* rows, long long b, long long width,
                        long long max_len, int sep_token, int pad_token,
                        int8_t* ids_out, uint8_t* quals_out,
                        int32_t* lengths_out, int qual_offset, int threads) {
  auto run_rows = [&](long long i0, long long i1) {
    for (long long i = i0; i < i1; ++i) {
      const int64_t* sp = spans + rows[i] * 8;
      const uint8_t* seq = buf + sp[2];
      const uint8_t* qual = buf + sp[4];
      long long t = sp[3];
      if (t > max_len - 1) t = max_len - 1;
      if (t > width - 1) t = width - 1;
      int8_t* ids = ids_out + i * width;
      uint8_t* qs = quals_out + i * width;
      for (long long k = 0; k < t; ++k) ids[k] = norm_token(seq[k]);
      ids[t] = static_cast<int8_t>(sep_token);
      memset(ids + t + 1, pad_token, width - t - 1);
      for (long long k = 0; k < t; ++k) {
        int v = static_cast<int>(qual[k]) - qual_offset;
        qs[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
      memset(qs + t, 0, width - t);
      lengths_out[i] = static_cast<int32_t>(t + 1);
    }
  };
  if (threads <= 1 || b < 4) {
    run_rows(0, b);
    return;
  }
  const int nt = std::min<long long>(threads, b);
  std::vector<std::thread> pool;
  const long long per = (b + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    long long r0 = t * per, r1 = std::min<long long>(r0 + per, b);
    if (r0 >= r1) break;
    pool.emplace_back(run_rows, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Batched majority vote
// ---------------------------------------------------------------------------

// Sliding-window majority vote over each row's `lengths[r]` prefix of a
// padded (b, maxlen) int8 label matrix. Exact reference semantics
// (reference: src/smooth/utils.rs:48-97): window forced odd, tail windows
// shift left to stay full-size, two-way ties keep the original label.
void majority_vote_batch(const int8_t* labels, int8_t* out,
                         const int64_t* lengths, long long b, long long maxlen,
                         long long window, int threads) {
  if (window % 2 == 0) window += 1;
  const long long half = window / 2;
  auto run_rows = [&](long long r0, long long r1) {
    std::vector<int64_t> csum;
    for (long long r = r0; r < r1; ++r) {
      const int8_t* row = labels + r * maxlen;
      int8_t* orow = out + r * maxlen;
      const long long len = std::min<long long>(lengths[r], maxlen);
      memcpy(orow, row, maxlen);  // padding passes through
      if (len <= 0) continue;
      csum.resize(len + 1);
      csum[0] = 0;
      for (long long i = 0; i < len; ++i)
        csum[i + 1] = csum[i] + (row[i] == 1 ? 1 : 0);
      for (long long i = 0; i < len; ++i) {
        long long s = std::max<long long>(i - half, 0);
        long long e = std::min<long long>(i + half + 1, len);
        if (e == len && e - s < window) s = std::max<long long>(e - window, 0);
        const long long ones = csum[e] - csum[s];
        const long long size = e - s;
        const long long twice = 2 * ones;
        orow[i] = twice > size ? 1 : (twice < size ? 0 : row[i]);
      }
    }
  };
  if (threads <= 1 || b < 4) {
    run_rows(0, b);
    return;
  }
  const int nt = std::min<long long>(threads, b);
  std::vector<std::thread> pool;
  const long long per = (b + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    long long r0 = t * per, r1 = std::min<long long>(r0 + per, b);
    if (r0 >= r1) break;
    pool.emplace_back(run_rows, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// 1-runs -> [start, end) regions with the reference's index-0 sentinel
// (a run touching index 0 opens at index 1; reference: src/utils.rs:671-695).
// Writes up to max_regions (start, end) pairs; returns the count.
long long label_regions(const int8_t* labels, long long n, long long* out,
                        long long max_regions) {
  long long cnt = 0;
  long long start = 0;
  for (long long i = 0; i < n && cnt < max_regions; ++i) {
    if (labels[i] == 1) {
      if (start == 0) start = i == 0 ? 0 : i;
      // start stays 0 while i==0; re-assigned at i==1 per the sentinel quirk.
      if (start == 0) continue;
    } else if (start != 0) {
      out[2 * cnt] = start;
      out[2 * cnt + 1] = i;
      cnt++;
      start = 0;
    }
  }
  if (start != 0 && cnt < max_regions) {
    out[2 * cnt] = start;
    out[2 * cnt + 1] = n;
    cnt++;
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// Chunk chop: the full per-read split/annotate/passthrough stage in one call
// ---------------------------------------------------------------------------

namespace {

struct ChopOut {
  uint8_t* out;
  long long cap;
  long long len = 0;
  bool overflow = false;

  void put(const uint8_t* p, long long n) {
    if (len + n > cap) { overflow = true; return; }
    memcpy(out + len, p, n);
    len += n;
  }
  void put_byte(uint8_t c) {
    if (len + 1 > cap) { overflow = true; return; }
    out[len++] = c;
  }
  void put_norm(const uint8_t* p, long long n) {
    if (len + n > cap) { overflow = true; return; }
    for (long long i = 0; i < n; ++i) out[len + i] = norm_base(p[i]);
    len += n;
  }
  void put_int(long long v) {
    char tmp[24];
    int n = snprintf(tmp, sizeof tmp, "%lld", v);
    put(reinterpret_cast<const uint8_t*>(tmp), n);
  }
};

}  // namespace

// Chop a chunk of indexed FASTQ records given per-read adapter intervals.
// Byte-for-byte identical to the Python chop stage (io/chop.py +
// infer/fused._chop_chunk; reference semantics: src/output/split.rs:171-226,
// src/bin/predict.rs:141-164):
//   * guard-rail passthrough (short read / zero or >mpi intervals / truncated
//     prediction): raw bytes, full header;
//   * --ocq: emit the adapter segments themselves, normalized seq, name-only
//     ids "<name>|s:e";
//   * otherwise: interval complement with the total_length-1 trailing trim,
//     min-length filter, "<name>|s:e|T/I" annotation; chop-type mismatch or
//     first kept part spanning the whole read => normalized-seq passthrough
//     under the name-only id.
// ivals: flattened (start, end) pairs; per read `ival_off[i]` (pair index)
// and `ival_cnt[i]` pairs. chop_type: 0=all 1=terminal 2=internal.
// Returns bytes written, or -1 on output overflow, -(i+10) on an interval
// outside read i's sequence (caller falls back to the Python path).
long long chop_records(const uint8_t* buf, const int64_t* spans,
                       long long n_records, const int64_t* ivals,
                       const int64_t* ival_off, const int64_t* ival_cnt,
                       const uint8_t* truncated, long long min_read_len,
                       long long max_process_intervals, long long min_chop_len,
                       int ocq, int chop_type, int id_annotation,
                       uint8_t* out, long long out_cap,
                       long long* out_records) {
  ChopOut o{out, out_cap};
  long long written = 0;
  for (long long i = 0; i < n_records; ++i) {
    const int64_t* sp = spans + 8 * i;
    const long long id_off = sp[0], name_len = sp[1];
    const long long s_off = sp[2], s_len = sp[3];
    const long long q_off = sp[4], q_len = sp[5];
    const long long d_off = sp[6], d_len = sp[7];
    const long long header_end = d_off >= 0 ? d_off + d_len : id_off + name_len;
    const long long cnt = ival_cnt[i];
    const int64_t* iv = ivals + 2 * ival_off[i];

    if (s_len < min_read_len || cnt <= 0 || cnt > max_process_intervals ||
        truncated[i]) {
      // Guard-rail passthrough: raw bytes, full header line.
      o.put_byte('@');
      o.put(buf + id_off, header_end - id_off);
      o.put_byte('\n');
      o.put(buf + s_off, s_len);
      o.put(reinterpret_cast<const uint8_t*>("\n+\n"), 3);
      o.put(buf + q_off, q_len);
      o.put_byte('\n');
      written++;
      if (o.overflow) return -1;
      continue;
    }

    if (ocq) {  // emit the adapter segments themselves
      for (long long k = 0; k < cnt; ++k) {
        const long long s = iv[2 * k], e = iv[2 * k + 1];
        o.put_byte('@');
        o.put(buf + id_off, name_len);
        o.put_byte('|');
        o.put_int(s);
        o.put_byte(':');
        o.put_int(e);
        o.put_byte('\n');
        o.put_norm(buf + s_off + s, e - s);
        o.put(reinterpret_cast<const uint8_t*>("\n+\n"), 3);
        o.put(buf + q_off + s, e - s);
        o.put_byte('\n');
        written++;
      }
      if (o.overflow) return -1;
      continue;
    }

    // Interval complement with the reference's trailing-base trim
    // (src/output/split.rs:260-292). Intervals arrive sorted by start.
    std::vector<long long> sel;
    sel.reserve(2 * (cnt + 1));
    long long cur = 0;
    for (long long k = 0; k < cnt; ++k) {
      const long long s = iv[2 * k], e = iv[2 * k + 1];
      if (cur < s) { sel.push_back(cur); sel.push_back(s); }
      cur = e;
    }
    if (cur < s_len - 1) {
      sel.push_back(cur);
      sel.push_back(s_len - 1);
    }
    const long long count_before = static_cast<long long>(sel.size()) / 2;
    for (long long k = 0; k < count_before; ++k)
      if (sel[2 * k] >= s_len) return -(i + 10);
    // min-length filter
    std::vector<long long> kept;
    kept.reserve(sel.size());
    for (long long k = 0; k < count_before; ++k) {
      if (sel[2 * k + 1] - sel[2 * k] >= min_chop_len) {
        kept.push_back(sel[2 * k]);
        kept.push_back(sel[2 * k + 1]);
      }
    }
    const long long n_kept = static_cast<long long>(kept.size()) / 2;
    const bool is_terminal = count_before == 1;
    const bool type_mismatch = (chop_type == 1 && !is_terminal) ||
                               (chop_type == 2 && is_terminal);
    const bool whole_span = n_kept > 0 && (kept[1] - kept[0]) == s_len;
    if (type_mismatch || whole_span) {
      // Split-stage passthrough: normalized seq, name-only id.
      o.put_byte('@');
      o.put(buf + id_off, name_len);
      o.put_byte('\n');
      o.put_norm(buf + s_off, s_len);
      o.put(reinterpret_cast<const uint8_t*>("\n+\n"), 3);
      o.put(buf + q_off, q_len);
      o.put_byte('\n');
      written++;
      if (o.overflow) return -1;
      continue;
    }
    const char suffix = is_terminal ? 'T' : 'I';
    for (long long k = 0; k < n_kept; ++k) {
      const long long s = kept[2 * k], e = kept[2 * k + 1];
      o.put_byte('@');
      o.put(buf + id_off, name_len);
      o.put_byte('|');
      o.put_int(s);
      o.put_byte(':');
      o.put_int(e);
      if (id_annotation) {
        o.put_byte('|');
        o.put_byte(suffix);
      }
      o.put_byte('\n');
      o.put_norm(buf + s_off + s, e - s);
      o.put(reinterpret_cast<const uint8_t*>("\n+\n"), 3);
      o.put(buf + q_off + s, e - s);
      o.put_byte('\n');
      written++;
    }
    if (o.overflow) return -1;
  }
  *out_records = written;
  return o.len;
}

// ---------------------------------------------------------------------------
// BGZF block compression (thread-pooled)
// ---------------------------------------------------------------------------

static const long long BGZF_MAX_PAYLOAD = 65280;
// Worst-case compressed block: payload + deflate overhead + 26-byte wrapper.
static const long long BGZF_MAX_BLOCK = 65536;

// Compress one payload (<= 65280 bytes) into a standalone BGZF block at `out`
// (capacity must be >= BGZF_MAX_BLOCK). Returns the block's byte length or a
// negative zlib error.
long long bgzf_block(const uint8_t* data, long long n, uint8_t* out,
                     int level) {
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return -1;
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = out + 18;
  zs.avail_out = static_cast<uInt>(BGZF_MAX_BLOCK - 26);
  int rc = deflate(&zs, Z_FINISH);
  long long clen = static_cast<long long>(zs.total_out);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return -2;
  const long long bsize = clen + 26 - 1;
  // 18-byte gzip header with the BC extra field.
  const uint8_t hdr[18] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                           6,    0,    0x42, 0x43, 2, 0,
                           static_cast<uint8_t>(bsize & 0xff),
                           static_cast<uint8_t>((bsize >> 8) & 0xff)};
  memcpy(out, hdr, 18);
  uint32_t crc = crc32(0, data, static_cast<uInt>(n));
  uint8_t* foot = out + 18 + clen;
  foot[0] = crc & 0xff; foot[1] = (crc >> 8) & 0xff;
  foot[2] = (crc >> 16) & 0xff; foot[3] = (crc >> 24) & 0xff;
  uint32_t isize = static_cast<uint32_t>(n);
  foot[4] = isize & 0xff; foot[5] = (isize >> 8) & 0xff;
  foot[6] = (isize >> 16) & 0xff; foot[7] = (isize >> 24) & 0xff;
  return 26 + clen;
}

// Compress a whole buffer into consecutive BGZF blocks using `threads`
// workers (blocks are independent deflate streams — the property the
// reference's noodles multithreaded writer exploits). `out` capacity must be
// >= ceil(n / 65280) * BGZF_MAX_BLOCK + 28. Appends the EOF marker when
// `final_eof` != 0. Returns total bytes written or negative on error.
long long bgzf_compress_buffer(const uint8_t* data, long long n, uint8_t* out,
                               int level, int threads, int final_eof) {
  const long long nblocks = n == 0 ? 0 : (n + BGZF_MAX_PAYLOAD - 1) / BGZF_MAX_PAYLOAD;
  std::vector<long long> sizes(static_cast<size_t>(nblocks), 0);
  std::vector<std::vector<uint8_t>> blocks(static_cast<size_t>(nblocks));
  std::atomic<long long> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    for (;;) {
      long long i = next.fetch_add(1);
      if (i >= nblocks || failed.load()) return;
      const long long off = i * BGZF_MAX_PAYLOAD;
      const long long len = std::min(BGZF_MAX_PAYLOAD, n - off);
      blocks[i].resize(BGZF_MAX_BLOCK);
      long long sz = bgzf_block(data + off, len, blocks[i].data(), level);
      if (sz < 0) { failed.store(true); return; }
      sizes[i] = sz;
    }
  };
  const int nt = std::max<long long>(1, std::min<long long>(threads, nblocks ? nblocks : 1));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (failed.load()) return -1;
  long long total = 0;
  for (long long i = 0; i < nblocks; ++i) {
    memcpy(out + total, blocks[i].data(), sizes[i]);
    total += sizes[i];
  }
  if (final_eof) {
    static const uint8_t kEof[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
        0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
        0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};
    memcpy(out + total, kEof, 28);
    total += 28;
  }
  return total;
}

// ---------------------------------------------------------------------------
// BGZF parallel decompression
// ---------------------------------------------------------------------------

// Decompress a buffer of concatenated BGZF blocks. Block boundaries come from
// the BC extra field, so workers can inflate independent blocks in parallel
// (reference capability: noodles MultithreadedReader, src/output/bam.rs:199).
// Returns bytes written to `out` (capacity `out_cap`) or negative on error:
// -1 malformed, -2 inflate failure, -3 out buffer too small.
long long bgzf_decompress_buffer(const uint8_t* data, long long n,
                                 uint8_t* out, long long out_cap,
                                 int threads) {
  struct Block { long long in_off, in_len, out_off, out_len; };
  std::vector<Block> blocks;
  long long pos = 0, out_total = 0;
  while (pos + 18 <= n) {
    if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
    const long long bsize =
        (static_cast<long long>(data[pos + 16]) |
         (static_cast<long long>(data[pos + 17]) << 8)) + 1;
    if (pos + bsize > n) return -1;
    const uint8_t* foot = data + pos + bsize - 4;
    const long long isize = static_cast<long long>(foot[0]) |
                            (static_cast<long long>(foot[1]) << 8) |
                            (static_cast<long long>(foot[2]) << 16) |
                            (static_cast<long long>(foot[3]) << 24);
    blocks.push_back({pos, bsize, out_total, isize});
    out_total += isize;
    pos += bsize;
  }
  if (out_total > out_cap) return -3;
  std::atomic<long long> next{0};
  std::atomic<bool> failed{false};
  auto worker = [&]() {
    for (;;) {
      long long i = next.fetch_add(1);
      if (i >= static_cast<long long>(blocks.size()) || failed.load()) return;
      const Block& blk = blocks[i];
      if (blk.out_len == 0) continue;
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) { failed.store(true); return; }
      zs.next_in = const_cast<uint8_t*>(data + blk.in_off + 18);
      zs.avail_in = static_cast<uInt>(blk.in_len - 26);
      zs.next_out = out + blk.out_off;
      zs.avail_out = static_cast<uInt>(blk.out_len);
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) failed.store(true);
    }
  };
  const int nt = std::max<long long>(1, std::min<long long>(threads, blocks.size() ? blocks.size() : 1));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  if (failed.load()) return -2;
  return out_total;
}

}  // extern "C"
