// Native host-side LZ4 runtime for lz4jpeg_tpu.
//
// Implements the two wire formats of the framework at C++ speed:
//
//  * fast frame ("LZ4T", spec in formats/fast_frame.py): greedy single-probe
//    hash-table encoder over 64 KiB blocks, byte-identical to the Python
//    executable spec; safe decoder.
//  * parity frame: the reference's exact semantics (brute-force greedy
//    longest match over 300-byte blocks, earliest-candidate tie break,
//    uint8 length truncation — see oracle/lz4_oracle.py and
//    Algorithms/sequential/LZ4/LZ4.c:290-620 for the behavior being
//    reproduced), bit-exact with the committed golden compressed.bin.
//
// Exposed as a plain C ABI for ctypes (native/__init__.py).  All entry
// points return the number of bytes written, or a negative error code.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kErrOutputFull = -1;
constexpr int kErrBadInput = -2;

// ---------------------------------------------------------------------------
// Fast frame ("LZ4T")
// ---------------------------------------------------------------------------

constexpr uint32_t kMagic = 0x54345A4C;  // "LZ4T"
constexpr uint8_t kVersion = 1;
constexpr int kBlockLog = 16;
constexpr uint32_t kRawFlag = 0x80000000u;
constexpr int kHashLog = 13;
constexpr uint32_t kHashMult = 2654435761u;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/ARM/TPU VMs)
}

inline uint32_t hash32(uint32_t x) {
  return (x * kHashMult) >> (32 - kHashLog);
}

// CRC32 (zlib polynomial, reflected 0xEDB88320) for the frame's 16-bit
// content checksum — must match zlib.crc32 byte for byte so the C++ and
// Python writers emit identical headers (formats/fast_frame.py).
struct Crc32Table {
  uint32_t table[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
};

inline const uint32_t* crc32_table() {
  // C++11 function-local static: initialization is thread-safe, unlike a
  // hand-rolled bool flag (callers may come from threads without the GIL).
  static const Crc32Table t;
  return t.table;
}

inline uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  const uint32_t* t = crc32_table();
  crc ^= 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) crc = t[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// Fold into [1, 0xFFFF]; 0 in the header means "checksum absent".
inline uint16_t fold_checksum16(uint32_t crc) {
  return static_cast<uint16_t>(crc % 0xFFFFu + 1);
}

inline void put16(std::vector<uint8_t>& out, uint16_t v) {
  out.push_back(v & 0xFF);
  out.push_back(v >> 8);
}

inline void put32(std::vector<uint8_t>& out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out.push_back((v >> (8 * i)) & 0xFF);
}

inline void put64(std::vector<uint8_t>& out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out.push_back((v >> (8 * i)) & 0xFF);
}


inline uint8_t* emit_ext_raw(uint8_t* w, size_t value) {
  while (value >= 255) {
    *w++ = 255;
    value -= 255;
  }
  *w++ = static_cast<uint8_t>(value);
  return w;
}

// Greedy single-probe walk — must stay in lockstep with
// formats/fast_frame.py::compress_block (tested byte-identical).
// Writes into `w` (caller guarantees worst-case capacity) and returns the
// number of bytes written.
size_t compress_block_fast(const uint8_t* block, size_t n, uint8_t* w,
                           int32_t* table) {
  std::memset(table, -1, sizeof(int32_t) << kHashLog);
  uint8_t* const w0 = w;
  size_t i = 0, anchor = 0;
  while (i + 4 <= n) {
    uint32_t h = hash32(load32(block + i));
    int32_t cand = table[h];
    table[h] = static_cast<int32_t>(i);
    if (cand >= 0 && i - static_cast<size_t>(cand) <= 0xFFFF &&
        load32(block + cand) == load32(block + i)) {
      size_t len = 4;
      while (i + len < n && block[cand + len] == block[i + len]) ++len;
      size_t lit = i - anchor;
      size_t ml = len - 4;
      *w++ = static_cast<uint8_t>(((lit < 15 ? lit : 15) << 4) |
                                  (ml < 15 ? ml : 15));
      if (lit >= 15) w = emit_ext_raw(w, lit - 15);
      std::memcpy(w, block + anchor, lit);
      w += lit;
      uint16_t off = static_cast<uint16_t>(i - cand);
      std::memcpy(w, &off, 2);
      w += 2;
      if (ml >= 15) w = emit_ext_raw(w, ml - 15);
      i += len;
      anchor = i;
    } else {
      ++i;
    }
  }
  size_t lit = n - anchor;
  *w++ = static_cast<uint8_t>((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) w = emit_ext_raw(w, lit - 15);
  std::memcpy(w, block + anchor, lit);
  w += lit;
  return static_cast<size_t>(w - w0);
}

int64_t decompress_block_fast(const uint8_t* payload, size_t n, uint8_t* out,
                              size_t out_start, size_t out_cap,
                              size_t raw_size) {
  size_t p = 0, w = out_start;
  const size_t end = out_start + raw_size;
  while (p < n) {
    if (w > end) return kErrBadInput;
    uint8_t token = payload[p++];
    size_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (p >= n) return kErrBadInput;
        b = payload[p++];
        lit += b;
      } while (b == 255);
    }
    if (p + lit > n || w + lit > out_cap) return kErrBadInput;
    std::memcpy(out + w, payload + p, lit);
    p += lit;
    w += lit;
    if (p == n) break;  // final literals-only sequence
    if (p + 2 > n) return kErrBadInput;
    size_t offset = payload[p] | (payload[p + 1] << 8);
    p += 2;
    if (offset == 0 || offset > w) return kErrBadInput;
    size_t ml = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t b;
      do {
        if (p >= n) return kErrBadInput;
        b = payload[p++];
        ml += b;
      } while (b == 255);
    }
    if (w + ml > out_cap) return kErrBadInput;
    if (offset >= ml) {
      std::memcpy(out + w, out + w - offset, ml);
      w += ml;
    } else {
      // Overlapping copy: replicate the period in doubling memmove chunks.
      size_t copied = offset;
      std::memcpy(out + w, out + w - offset, offset);
      while (copied < ml) {
        size_t chunk = copied < ml - copied ? copied : ml - copied;
        std::memcpy(out + w + copied, out + w, chunk);
        copied += chunk;
      }
      w += ml;
    }
  }
  if (w != end) return kErrBadInput;
  return static_cast<int64_t>(raw_size);
}

// ---------------------------------------------------------------------------
// Parity frame (reference wire format; see oracle/lz4_oracle.py)
// ---------------------------------------------------------------------------

constexpr int kMinMatch = 4;
constexpr int kMaxMatch = 1024;

// Greedy longest-match scan with the reference's exact semantics: candidates
// oldest->newest, strict > keeps the earliest (largest-offset) maximum, the
// >=4 check is on the untruncated length, the result is truncated mod 256.
void find_longest_match_parity(const uint8_t* block, size_t n, size_t pos,
                               unsigned* out_len, unsigned* out_dist) {
  size_t best = 0, best_dist = 0;
  for (size_t i = 0; i < pos; ++i) {
    size_t m = 0;
    while (m < static_cast<size_t>(kMaxMatch) && pos + m < n &&
           block[i + m] == block[pos + m])
      ++m;
    if (m > best) {
      best = m;
      best_dist = pos - i;
    }
  }
  if (best >= static_cast<size_t>(kMinMatch)) {
    *out_len = static_cast<unsigned>(best & 0xFF);
    *out_dist = static_cast<unsigned>(best_dist & 0xFFFF);
  } else {
    *out_len = 0;
    *out_dist = 0;
  }
}

size_t ext_len_count(unsigned value) {
  size_t k = 0;
  while (value >= 255) {
    ++k;
    value -= 255;
  }
  return k + 1;
}

void write_ext_parity(std::vector<uint8_t>& out, unsigned value) {
  while (value >= 255) {
    out.push_back(255);
    value -= 255;
  }
  out.push_back(static_cast<uint8_t>(value));
}

struct ParitySeq {
  size_t lit_start, lit_count;
  unsigned offset, length;  // length already uint8-truncated; 0 = tail
};

// block_encode (LZ4.c:506-620) semantics; emits into `out`, returns the
// serialized block byte size (including the 3-byte header).
int64_t encode_block_parity(const uint8_t* block, size_t n,
                            std::vector<uint8_t>& out) {
  std::vector<ParitySeq> seqs;
  size_t idx = 0, lit_start = 0, lit_count = 0;
  while (idx < n) {
    unsigned ml, dist;
    find_longest_match_parity(block, n, idx, &ml, &dist);
    if (ml == 0) {
      if (lit_count == 0) lit_start = idx;
      ++idx;
      ++lit_count;
    } else {
      seqs.push_back({lit_start, lit_count, dist, ml});
      lit_count = 0;
      idx += ml;
    }
  }
  if (lit_count > 0) seqs.push_back({lit_start, lit_count, 0, 0});

  size_t block_size = 3;
  for (const auto& s : seqs) {
    size_t sz = s.lit_count + 5;
    if (s.lit_count >= 15) sz += ext_len_count((s.lit_count - 15) & 0xFF);
    if (s.length != 0) {
      unsigned adj = (s.length - 4) & 0xFF;
      if (adj >= 15) sz += ext_len_count((adj - 15) & 0xFF);
    }
    // The parity format cannot represent >270-byte literal runs (the
    // reference's own decoder desyncs); mirror formats/lz4_frame.py.
    if (s.lit_count > 270) return kErrBadInput;
    block_size += sz;
  }

  out.push_back(static_cast<uint8_t>(seqs.size() & 0xFF));
  put16(out, static_cast<uint16_t>(block_size & 0xFFFF));
  for (const auto& s : seqs) {
    unsigned token_lit = s.lit_count >= 15 ? 15 : s.lit_count;
    unsigned token_ml =
        s.length == 0 ? 0 : (s.length >= 19 ? 15 : (s.length - 4) & 0xFF);
    out.push_back(static_cast<uint8_t>(((token_lit << 4) | token_ml) & 0xFF));
    size_t sz = s.lit_count + 5;
    if (s.lit_count >= 15) sz += ext_len_count((s.lit_count - 15) & 0xFF);
    if (s.length != 0) {
      unsigned adj = (s.length - 4) & 0xFF;
      if (adj >= 15) sz += ext_len_count((adj - 15) & 0xFF);
    }
    put16(out, static_cast<uint16_t>(sz & 0xFFFF));
    if (s.lit_count >= 15) write_ext_parity(out, (s.lit_count - 15) & 0xFF);
    out.insert(out.end(), block + s.lit_start,
               block + s.lit_start + s.lit_count);
    put16(out, static_cast<uint16_t>(s.offset & 0xFFFF));
    if (s.length >= 4) {
      unsigned adj = (s.length - 4) & 0xFF;
      if (adj >= 15) write_ext_parity(out, (adj - 15) & 0xFF);
    }
  }
  return static_cast<int64_t>(block_size);
}

}  // namespace

extern "C" {

// Fast frame encode: data -> LZ4T frame.  Returns bytes written or <0.
int64_t lz4_encode_fast(const uint8_t* data, size_t n, uint8_t* out,
                        size_t out_cap) {
  const size_t block_size = 1u << kBlockLog;
  const size_t block_count = n == 0 ? 0 : (n + block_size - 1) / block_size;
  const size_t header = 20 + 4 * block_count;
  if (out_cap < header) return kErrOutputFull;
  std::memcpy(out, &kMagic, 4);
  out[4] = kVersion;
  out[5] = kBlockLog;
  const uint16_t csum = fold_checksum16(crc32_update(0, data, n));
  std::memcpy(out + 6, &csum, 2);
  uint64_t n64 = n;
  std::memcpy(out + 8, &n64, 8);
  uint32_t bc32 = static_cast<uint32_t>(block_count);
  std::memcpy(out + 16, &bc32, 4);
  // Scratch: one block's worst-case compressed size (raw-store caps the
  // frame, but the transient compress output can exceed the block).
  std::vector<uint8_t> scratch(block_size + block_size / 255 + 64);
  std::vector<int32_t> table(1u << kHashLog);
  size_t w = header;
  for (size_t b = 0; b < block_count; ++b) {
    const uint8_t* p = data + b * block_size;
    const size_t len = (b + 1) * block_size <= n ? block_size : n - b * block_size;
    const size_t comp = compress_block_fast(p, len, scratch.data(), table.data());
    uint32_t rec;
    const uint8_t* payload;
    size_t payload_len;
    if (comp >= len) {
      rec = static_cast<uint32_t>(len) | kRawFlag;
      payload = p;
      payload_len = len;
    } else {
      rec = static_cast<uint32_t>(comp);
      payload = scratch.data();
      payload_len = comp;
    }
    if (w + payload_len > out_cap) return kErrOutputFull;
    std::memcpy(out + w, payload, payload_len);
    w += payload_len;
    std::memcpy(out + 20 + 4 * b, &rec, 4);
  }
  return static_cast<int64_t>(w);
}

// Fast frame decode.  Returns raw bytes written or <0.
int64_t lz4_decode_fast(const uint8_t* data, size_t n, uint8_t* out,
                        size_t out_cap) {
  if (n < 20) return kErrBadInput;
  uint32_t magic;
  std::memcpy(&magic, data, 4);
  if (magic != kMagic || data[4] != kVersion) return kErrBadInput;
  const int block_log = data[5];
  uint64_t raw_size;
  std::memcpy(&raw_size, data + 8, 8);
  uint32_t block_count;
  std::memcpy(&block_count, data + 16, 4);
  if (raw_size > out_cap) return kErrOutputFull;
  const size_t block_size = 1ull << block_log;
  size_t p = 20 + 4ull * block_count;
  if (p > n) return kErrBadInput;
  size_t w = 0;
  for (uint32_t b = 0; b < block_count; ++b) {
    uint32_t rec;
    std::memcpy(&rec, data + 20 + 4ull * b, 4);
    const size_t expected =
        raw_size - w < block_size ? static_cast<size_t>(raw_size - w) : block_size;
    if (rec & kRawFlag) {
      const size_t len = rec & ~kRawFlag;
      if (len != expected || p + len > n) return kErrBadInput;
      std::memcpy(out + w, data + p, len);
      p += len;
      w += len;
    } else {
      if (p + rec > n) return kErrBadInput;
      int64_t got =
          decompress_block_fast(data + p, rec, out, w, out_cap, expected);
      if (got < 0) return got;
      p += rec;
      w += expected;
    }
  }
  if (p != n || w != raw_size) return kErrBadInput;
  uint16_t want_csum;
  std::memcpy(&want_csum, data + 6, 2);
  if (want_csum != 0 &&
      fold_checksum16(crc32_update(0, out, w)) != want_csum)
    return kErrBadInput;
  return static_cast<int64_t>(w);
}

// Streaming-chunk encode: compress `n` bytes as consecutive 2^block_log
// blocks in ONE call (the encode_file path — chunk granularity instead of
// one ctypes round trip per 64 KiB block).  Payloads are concatenated into
// `out`; `sizes_out[i]` gets the RAW_FLAG-tagged size-table record for
// block i (raw-stored when compression does not shrink it), exactly as the
// frame writer would.  Returns total payload bytes written, or <0.
int64_t lz4t_encode_chunk(const uint8_t* data, size_t n, int block_log,
                          uint8_t* out, size_t out_cap, uint32_t* sizes_out) {
  if (block_log < 8 || block_log > 24) return kErrBadInput;
  const size_t block_size = 1ull << block_log;
  const size_t block_count = n == 0 ? 0 : (n + block_size - 1) / block_size;
  std::vector<uint8_t> scratch(block_size + block_size / 255 + 64);
  std::vector<int32_t> table(1u << kHashLog);
  size_t w = 0;
  for (size_t b = 0; b < block_count; ++b) {
    const uint8_t* p = data + b * block_size;
    const size_t len =
        (b + 1) * block_size <= n ? block_size : n - b * block_size;
    const size_t comp = compress_block_fast(p, len, scratch.data(), table.data());
    const uint8_t* payload;
    size_t payload_len;
    if (comp >= len) {
      sizes_out[b] = static_cast<uint32_t>(len) | kRawFlag;
      payload = p;
      payload_len = len;
    } else {
      sizes_out[b] = static_cast<uint32_t>(comp);
      payload = scratch.data();
      payload_len = comp;
    }
    if (w + payload_len > out_cap) return kErrOutputFull;
    std::memcpy(out + w, payload, payload_len);
    w += payload_len;
  }
  return static_cast<int64_t>(w);
}

// Streaming-chunk decode: `count` consecutive block payloads (concatenated
// in `payloads`, size-table records in `recs`) -> raw bytes, ONE call per
// chunk (the decode_file path; no per-block sub-frame wrapping).
// `raw_total` is the expected raw byte total of these blocks (all full
// blocks except possibly the last of the file).  Returns bytes written
// or <0.
int64_t lz4t_decode_chunk(const uint8_t* payloads, size_t n,
                          const uint32_t* recs, int64_t count, int block_log,
                          uint64_t raw_total, uint8_t* out, size_t out_cap) {
  if (block_log < 8 || block_log > 24) return kErrBadInput;
  if (raw_total > out_cap) return kErrOutputFull;
  const size_t block_size = 1ull << block_log;
  size_t p = 0, w = 0;
  for (int64_t b = 0; b < count; ++b) {
    const uint32_t rec = recs[b];
    const size_t expected =
        raw_total - w < block_size ? static_cast<size_t>(raw_total - w)
                                   : block_size;
    if (rec & kRawFlag) {
      const size_t len = rec & ~kRawFlag;
      if (len != expected || p + len > n) return kErrBadInput;
      std::memcpy(out + w, payloads + p, len);
      p += len;
      w += len;
    } else {
      if (p + rec > n) return kErrBadInput;
      int64_t got =
          decompress_block_fast(payloads + p, rec, out, w, out_cap, expected);
      if (got < 0) return got;
      p += rec;
      w += expected;
    }
  }
  if (p != n || w != raw_total) return kErrBadInput;
  return static_cast<int64_t>(w);
}

// Incremental CRC32 export for the streaming paths (zlib-compatible) so
// Python and C++ writers stay checksum-identical without recomputation.
uint32_t lz4t_crc32(uint32_t crc, const uint8_t* data, size_t n) {
  return crc32_update(crc, data, n);
}

// Parity frame encode (reference wire format).  Returns bytes written or <0.
int64_t lz4_encode_parity(const uint8_t* data, size_t n, uint8_t* out,
                          size_t out_cap, size_t block_length) {
  if (block_length == 0 || block_length == 500 || n < block_length)
    return kErrBadInput;
  const size_t block_count = (n + block_length - 1) / block_length;
  std::vector<uint8_t> frame;
  frame.reserve(n + n / 4 + 16);
  frame.push_back(static_cast<uint8_t>(block_count & 0xFF));
  for (size_t b = 0; b < block_count; ++b) {
    const uint8_t* p = data + b * block_length;
    const size_t len =
        (b + 1) * block_length <= n ? block_length : n - b * block_length;
    if (encode_block_parity(p, len, frame) < 0) return kErrBadInput;
  }
  if (frame.size() > out_cap) return kErrOutputFull;
  std::memcpy(out, frame.data(), frame.size());
  return static_cast<int64_t>(frame.size());
}

}  // extern "C"

extern "C" {

// Emit one LZ4T block payload from parse arrays (TPU fast-path serializer):
// is_match[k]=1 marks a sequence start at k with emit_len[k]/emit_dist[k];
// gaps are literals.  Each taken match is greedily EXTENDED while the
// distance-d prediction keeps holding: the device matcher caps lengths at
// its sort-carry width (4*LCP_WORDS bytes) and truncates at parse-segment
// boundaries, but the raw bytes are on hand here, so the cap costs nothing
// at emission time.  Parse marks swallowed by an extension are skipped.
// Returns payload bytes written, or <0.
int64_t lz4t_emit_block(const uint8_t* data, size_t n, const uint8_t* is_match,
                        const int32_t* emit_len, const int32_t* emit_dist,
                        uint8_t* out, size_t out_cap) {
  uint8_t* w = out;
  uint8_t* const w_end = out + out_cap;
  size_t anchor = 0, i = 0;
  while (i < n) {
    if (!is_match[i]) {
      ++i;
      continue;
    }
    size_t len = static_cast<size_t>(emit_len[i]);
    const size_t d = static_cast<size_t>(emit_dist[i]);
    // Backward extension: the anchor-strided matcher can only start
    // matches on its sampling grid; a real match beginning one byte
    // earlier shows up here one byte short.  Pending literals are free
    // to be re-consumed by the match as long as the distance-d
    // prediction holds (standard LZ4 encoder move).
    while (i > anchor && i > d && data[i - 1] == data[i - 1 - d]) {
      --i;
      ++len;
    }
    size_t lit = i - anchor;
    while (i + len < n && data[i + len] == data[i + len - d]) ++len;
    size_t ml = len - 4;
    if (w + 1 + lit / 255 + 3 + lit + 2 + ml / 255 + 2 > w_end)
      return kErrOutputFull;
    *w++ = static_cast<uint8_t>(((lit < 15 ? lit : 15) << 4) |
                                (ml < 15 ? ml : 15));
    if (lit >= 15) w = emit_ext_raw(w, lit - 15);
    std::memcpy(w, data + anchor, lit);
    w += lit;
    uint16_t off = static_cast<uint16_t>(d);
    std::memcpy(w, &off, 2);
    w += 2;
    if (ml >= 15) w = emit_ext_raw(w, ml - 15);
    i += len;
    anchor = i;
  }
  size_t lit = n - anchor;
  if (w + 1 + lit / 255 + 2 + lit > w_end) return kErrOutputFull;
  *w++ = static_cast<uint8_t>((lit < 15 ? lit : 15) << 4);
  if (lit >= 15) w = emit_ext_raw(w, lit - 15);
  std::memcpy(w, data + anchor, lit);
  w += lit;
  return static_cast<int64_t>(w - out);
}

// Batched emitter: B padded blocks with row stride `stride`, valid prefix
// lengths[b].  Payloads land back-to-back in `out`, per-block sizes in
// `sizes`.  One call replaces B ctypes round trips (the Python-per-block
// host tail that walled fast-mode encode at multi-GB inputs).  Returns
// total bytes written, or <0.
int64_t lz4t_emit_blocks(const uint8_t* data, int64_t num_blocks,
                         int64_t stride, const int32_t* lengths,
                         const uint8_t* is_match, const int32_t* emit_len,
                         const int32_t* emit_dist, uint8_t* out,
                         size_t out_cap, int64_t* sizes) {
  uint8_t* w = out;
  size_t rem = out_cap;
  for (int64_t b = 0; b < num_blocks; ++b) {
    const size_t off = static_cast<size_t>(b) * static_cast<size_t>(stride);
    int64_t got =
        lz4t_emit_block(data + off, static_cast<size_t>(lengths[b]),
                        is_match + off, emit_len + off, emit_dist + off,
                        w, rem);
    if (got < 0) return got;
    sizes[b] = got;
    w += got;
    rem -= static_cast<size_t>(got);
  }
  return static_cast<int64_t>(w - out);
}

}  // extern "C"

extern "C" {

// Build the device-decode copy program for a whole LZ4T frame: for every
// block, literal bytes land at their output offsets in `lit` (row-major
// (block_count, block_size), caller-zeroed) and match positions get their
// intra-block source index in `src` (caller-filled with -1; -1 = literal).
// Raw-stored blocks are pure literals.  The device then resolves every
// match position with one batched gather (ops/lz4t_decode.py) — this pass
// is the only serial part of the decode and runs at memcpy speed.
//
// Two depth optimizations keep the chains short:
//  * self-overlapping matches (offset < length, i.e. periodic runs) are
//    collapsed analytically — src points at `w-off + (j % off)`, depth 1
//    instead of length/offset;
//  * the exact chain depth is tracked per position; chains that would
//    exceed `depth_cap` are pre-rooted here (the builder keeps the root
//    array as a byproduct of its left-to-right walk).  depth_cap = 1
//    gives the fully rooted program the device gather takes.  The
//    realized maximum is written to *max_depth.
// Returns the block count, or <0 on malformed frames.
int64_t lz4t_build_copy_program(const uint8_t* data, size_t n, uint8_t* lit,
                                int32_t* src, int64_t* block_raw_sizes,
                                int64_t depth_cap, int64_t* max_depth) {
  if (n < 20) return kErrBadInput;
  uint32_t magic;
  std::memcpy(&magic, data, 4);
  if (magic != kMagic || data[4] != kVersion) return kErrBadInput;
  const int block_log = data[5];
  uint64_t raw_size;
  std::memcpy(&raw_size, data + 8, 8);
  uint32_t block_count;
  std::memcpy(&block_count, data + 16, 4);
  const size_t block_size = 1ull << block_log;
  size_t p = 20 + 4ull * block_count;
  if (p > n) return kErrBadInput;
  uint64_t done = 0;
  std::vector<int32_t> depth(block_size);
  std::vector<int32_t> root(block_size);
  int64_t deepest = 0;
  if (depth_cap < 1) depth_cap = 1;
  for (uint32_t b = 0; b < block_count; ++b) {
    uint32_t rec;
    std::memcpy(&rec, data + 20 + 4ull * b, 4);
    const size_t expected =
        raw_size - done < block_size ? static_cast<size_t>(raw_size - done)
                                     : block_size;
    uint8_t* lrow = lit + static_cast<size_t>(b) * block_size;
    int32_t* srow = src + static_cast<size_t>(b) * block_size;
    if (rec & kRawFlag) {
      const size_t len = rec & ~kRawFlag;
      if (len != expected || p + len > n) return kErrBadInput;
      std::memcpy(lrow, data + p, len);
      p += len;
    } else {
      if (p + rec > n) return kErrBadInput;
      const uint8_t* payload = data + p;
      std::memset(depth.data(), 0, expected * sizeof(int32_t));
      size_t q = 0, w = 0;
      while (q < rec) {
        uint8_t token = payload[q++];
        size_t run = token >> 4;
        if (run == 15) {
          uint8_t e;
          do {
            if (q >= rec) return kErrBadInput;
            e = payload[q++];
            run += e;
          } while (e == 255);
        }
        if (q + run > rec || w + run > expected) return kErrBadInput;
        std::memcpy(lrow + w, payload + q, run);
        for (size_t j = 0; j < run; ++j)
          root[w + j] = static_cast<int32_t>(w + j);
        q += run;
        w += run;
        if (q == rec) break;  // final literals-only sequence
        if (q + 2 > rec) return kErrBadInput;
        size_t offset = payload[q] | (payload[q + 1] << 8);
        q += 2;
        if (offset == 0 || offset > w) return kErrBadInput;
        size_t ml = (token & 0xF) + 4;
        if ((token & 0xF) == 15) {
          uint8_t e;
          do {
            if (q >= rec) return kErrBadInput;
            e = payload[q++];
            ml += e;
          } while (e == 255);
        }
        if (w + ml > expected) return kErrBadInput;
        for (size_t j = 0; j < ml; ++j) {
          // Periodic self-overlap collapses to one hop into the source
          // period; non-overlapping matches point straight across.
          size_t s = w - offset + (j < offset ? j : j % offset);
          int32_t d = depth[s] + 1;
          if (d > depth_cap) {
            s = static_cast<size_t>(root[s]);  // pre-root deep chains
            d = 1;
          }
          srow[w + j] = static_cast<int32_t>(s);
          depth[w + j] = d;
          root[w + j] = root[s];
          if (d > deepest) deepest = d;
        }
        w += ml;
      }
      if (w != expected) return kErrBadInput;
      p += rec;
    }
    block_raw_sizes[b] = static_cast<int64_t>(expected);
    done += expected;
  }
  if (p != n || done != raw_size) return kErrBadInput;
  *max_depth = deepest;
  return static_cast<int64_t>(block_count);
}

}  // extern "C"

extern "C" {

// Canonical Huffman decode (host side of the shared-codebook entropy
// stage).  `lengths` ascending with `symbols` in canonical order (the
// CanonicalCodebook layout).  Returns symbol count written, or <0.
int64_t huff_unpack(const uint8_t* packed, uint64_t nbits,
                    const uint8_t* lengths, const int32_t* symbols,
                    size_t num_symbols, int32_t* out, size_t out_cap) {
  if (num_symbols == 0) return nbits == 0 ? 0 : kErrBadInput;
  // first_code/first_index per length (canonical code arithmetic).
  uint32_t first_code[33] = {0};
  int32_t first_index[33];
  uint32_t count_len[33] = {0};
  for (int l = 0; l <= 32; ++l) first_index[l] = -1;
  for (size_t s = 0; s < num_symbols; ++s) {
    int l = lengths[s];
    if (l < 1 || l > 32) return kErrBadInput;
    if (first_index[l] < 0) first_index[l] = static_cast<int32_t>(s);
    ++count_len[l];
  }
  uint32_t code = 0;
  int prev = 0;
  for (int l = 1; l <= 32; ++l) {
    if (!count_len[l]) continue;
    code <<= (l - prev);
    prev = l;
    first_code[l] = code;
    code += count_len[l];
  }
  size_t w = 0;
  uint32_t acc = 0;
  int acc_len = 0;
  for (uint64_t i = 0; i < nbits; ++i) {
    acc = (acc << 1) | ((packed[i >> 3] >> (7 - (i & 7))) & 1);
    ++acc_len;
    if (acc_len > 32) return kErrBadInput;
    if (first_index[acc_len] >= 0 &&
        acc >= first_code[acc_len] &&
        acc < first_code[acc_len] + count_len[acc_len]) {
      if (w >= out_cap) return kErrOutputFull;
      out[w++] = symbols[first_index[acc_len] + (acc - first_code[acc_len])];
      acc = 0;
      acc_len = 0;
    }
  }
  if (acc_len != 0) return kErrBadInput;
  return static_cast<int64_t>(w);
}

}  // extern "C"

extern "C" {

// Pack per-symbol canonical codes MSB-first into a byte stream (host side
// of the shared-codebook entropy stage).  Returns total bits, or <0.
int64_t huff_pack(const uint32_t* codes, const uint8_t* lengths, size_t n,
                  uint8_t* out, size_t out_cap) {
  uint64_t acc = 0;
  int acc_bits = 0;
  size_t w = 0;
  uint64_t total_bits = 0;
  for (size_t i = 0; i < n; ++i) {
    int l = lengths[i];
    acc = (acc << l) | (codes[i] & ((l == 32 ? 0xFFFFFFFFu : ((1u << l) - 1))));
    acc_bits += l;
    total_bits += l;
    while (acc_bits >= 8) {
      if (w >= out_cap) return kErrOutputFull;
      out[w++] = static_cast<uint8_t>((acc >> (acc_bits - 8)) & 0xFF);
      acc_bits -= 8;
    }
  }
  if (acc_bits > 0) {
    if (w >= out_cap) return kErrOutputFull;
    out[w++] = static_cast<uint8_t>((acc << (8 - acc_bits)) & 0xFF);
  }
  return static_cast<int64_t>(total_bits);
}

}  // extern "C"

extern "C" {

// Shared-codebook entropy stage, single-pass over padded RLE pairs
// (models/jpeg.py stores (N, 2L) int32 rows with per-row valid lengths).
// The throttled-host numpy equivalents (mask-compact + np.unique) cost
// seconds at multi-megapixel streams; these two passes are memory-speed.

// Histogram of valid symbols, shifted by `offset` into [0, nbins).
// Returns the number of valid symbols, or <0 if any falls outside.
int64_t rle_symbol_hist(const int32_t* pairs, const int32_t* lengths,
                        size_t n_rows, size_t row_len, int64_t offset,
                        int64_t* counts, size_t nbins) {
  int64_t total = 0;
  for (size_t r = 0; r < n_rows; ++r) {
    const int32_t* row = pairs + r * row_len;
    int32_t n = lengths[r];
    if (n < 0 || static_cast<size_t>(n) > row_len) return kErrBadInput;
    for (int32_t i = 0; i < n; ++i) {
      int64_t v = static_cast<int64_t>(row[i]) + offset;
      if (v < 0 || v >= static_cast<int64_t>(nbins)) return kErrBadInput;
      ++counts[v];
    }
    total += n;
  }
  return total;
}

// Map valid symbols through a dense (code, length) LUT over
// [lut_base, lut_base + lut_size) and pack MSB-first, np.packbits-style.
// Returns bytes written; *nbits_out gets the exact bit count.
int64_t huff_pack_pairs(const int32_t* pairs, const int32_t* lengths,
                        size_t n_rows, size_t row_len, int64_t lut_base,
                        const uint32_t* lut_codes, const uint8_t* lut_lens,
                        size_t lut_size, uint8_t* out, size_t out_cap,
                        uint64_t* nbits_out) {
  uint64_t acc = 0;
  int acc_bits = 0;
  size_t w = 0;
  uint64_t nbits = 0;
  for (size_t r = 0; r < n_rows; ++r) {
    const int32_t* row = pairs + r * row_len;
    int32_t n = lengths[r];
    if (n < 0 || static_cast<size_t>(n) > row_len) return kErrBadInput;
    for (int32_t i = 0; i < n; ++i) {
      int64_t v = static_cast<int64_t>(row[i]) - lut_base;
      if (v < 0 || v >= static_cast<int64_t>(lut_size)) return kErrBadInput;
      int len = lut_lens[v];
      if (len < 1 || len > 32) return kErrBadInput;  // unseen symbol
      acc = (acc << len) | lut_codes[v];
      acc_bits += len;
      nbits += len;
      while (acc_bits >= 8) {
        if (w >= out_cap) return kErrOutputFull;
        out[w++] = static_cast<uint8_t>(acc >> (acc_bits - 8));
        acc_bits -= 8;
      }
    }
  }
  if (acc_bits > 0) {
    if (w >= out_cap) return kErrOutputFull;
    out[w++] = static_cast<uint8_t>((acc << (8 - acc_bits)) & 0xFF);
  }
  *nbits_out = nbits;
  return static_cast<int64_t>(w);
}

}  // extern "C"

extern "C" {

// Canonical Huffman decode + RLE re-blocking in one pass: the decode half
// of the shared entropy stage (models/jpeg.py entropy_decode).  Symbols
// alternate (count, value); a pair belongs to the block where its running
// count total lands ((cum-1) / block_size, matching _split_symbols).
// Strictly validating — returns kErrBadInput on any stream the vectorized
// numpy path would need its own (quirkier) handling for, and the caller
// falls back so observable behavior is unchanged.
int64_t huff_unpack_pairs(const uint8_t* packed, uint64_t nbits,
                          const uint8_t* lengths, const int32_t* symbols,
                          size_t num_symbols, int64_t block_size,
                          int64_t num_blocks, int64_t pad_width,
                          int32_t* out_pairs, int32_t* out_lengths) {
  if (num_symbols == 0) return nbits == 0 ? 0 : kErrBadInput;
  uint32_t first_code[33] = {0};
  int32_t first_index[33];
  uint32_t count_len[33] = {0};
  for (int l = 0; l <= 32; ++l) first_index[l] = -1;
  for (size_t s = 0; s < num_symbols; ++s) {
    int l = lengths[s];
    if (l < 1 || l > 32) return kErrBadInput;
    if (first_index[l] < 0) first_index[l] = static_cast<int32_t>(s);
    ++count_len[l];
  }
  uint32_t code = 0;
  int prev = 0;
  for (int l = 1; l <= 32; ++l) {
    if (!count_len[l]) continue;
    code <<= (l - prev);
    prev = l;
    first_code[l] = code;
    code += count_len[l];
  }
  int64_t cum = 0, cur_block = -1, cur_slot = 0, n_sym = 0;
  int32_t pending_count = 0;
  bool have_count = false;
  uint32_t acc = 0;
  int acc_len = 0;
  for (uint64_t i = 0; i < nbits; ++i) {
    acc = (acc << 1) | ((packed[i >> 3] >> (7 - (i & 7))) & 1);
    ++acc_len;
    if (acc_len > 32) return kErrBadInput;
    if (count_len[acc_len] &&
        acc - first_code[acc_len] < count_len[acc_len]) {
      int32_t sym =
          symbols[first_index[acc_len] + (acc - first_code[acc_len])];
      acc = 0;
      acc_len = 0;
      ++n_sym;
      if (!have_count) {
        if (sym <= 0) return kErrBadInput;  // count symbol must be positive
        pending_count = sym;
        have_count = true;
        continue;
      }
      have_count = false;
      cum += pending_count;
      int64_t blk = (cum - 1) / block_size;
      if (blk < 0 || blk >= num_blocks) return kErrBadInput;
      if (blk != cur_block) {
        if (blk < cur_block) return kErrBadInput;
        cur_block = blk;
        cur_slot = 0;
      }
      if (2 * cur_slot + 1 >= pad_width) return kErrBadInput;
      out_pairs[blk * pad_width + 2 * cur_slot] = pending_count;
      out_pairs[blk * pad_width + 2 * cur_slot + 1] = sym;
      out_lengths[blk] += 2;
      ++cur_slot;
    }
  }
  if (acc_len != 0 || have_count) return kErrBadInput;  // dangling bits/pair
  return n_sym;
}

}  // extern "C"

extern "C" {

// ---- packed-u16 RLE pair layout --------------------------------------
// One uint16 per [count, value] pair: (count-1) << 10 | (value + 512).
// The device packs this way to halve transfer bytes (ops/rle.py
// rle_encode_packed16); these are the C++ entropy passes that consume it
// directly, so the int32 pair layout is never materialized on the host.

static inline void unpack16(uint16_t v, int32_t* count, int32_t* value) {
  *count = (v >> 10) + 1;
  *value = static_cast<int32_t>(v & 0x3FF) - 512;
}

int64_t rle_symbol_hist16(const uint16_t* packed, const int32_t* lengths,
                          size_t n_rows, size_t row_len, int64_t offset,
                          int64_t* counts, size_t nbins) {
  int64_t total = 0;
  for (size_t r = 0; r < n_rows; ++r) {
    const uint16_t* row = packed + r * row_len;
    int32_t n = lengths[r];  // symbols = 2 * pairs
    if (n < 0 || n % 2 || static_cast<size_t>(n / 2) > row_len)
      return kErrBadInput;
    for (int32_t i = 0; i < n / 2; ++i) {
      int32_t c, v;
      unpack16(row[i], &c, &v);
      int64_t cb = static_cast<int64_t>(c) + offset;
      int64_t vb = static_cast<int64_t>(v) + offset;
      if (cb < 0 || cb >= static_cast<int64_t>(nbins) || vb < 0 ||
          vb >= static_cast<int64_t>(nbins))
        return kErrBadInput;
      ++counts[cb];
      ++counts[vb];
    }
    total += n;
  }
  return total;
}

int64_t huff_pack_pairs16(const uint16_t* packed, const int32_t* lengths,
                          size_t n_rows, size_t row_len, int64_t lut_base,
                          const uint32_t* lut_codes, const uint8_t* lut_lens,
                          size_t lut_size, uint8_t* out, size_t out_cap,
                          uint64_t* nbits_out) {
  uint64_t acc = 0;
  int acc_bits = 0;
  size_t w = 0;
  uint64_t nbits = 0;
  for (size_t r = 0; r < n_rows; ++r) {
    const uint16_t* row = packed + r * row_len;
    int32_t n = lengths[r];
    if (n < 0 || n % 2 || static_cast<size_t>(n / 2) > row_len)
      return kErrBadInput;
    for (int32_t i = 0; i < n / 2; ++i) {
      int32_t cv[2];
      unpack16(row[i], &cv[0], &cv[1]);
      for (int s = 0; s < 2; ++s) {
        int64_t v = static_cast<int64_t>(cv[s]) - lut_base;
        if (v < 0 || v >= static_cast<int64_t>(lut_size)) return kErrBadInput;
        int len = lut_lens[v];
        if (len < 1 || len > 32) return kErrBadInput;
        acc = (acc << len) | lut_codes[v];
        acc_bits += len;
        nbits += len;
        while (acc_bits >= 8) {
          if (w >= out_cap) return kErrOutputFull;
          out[w++] = static_cast<uint8_t>(acc >> (acc_bits - 8));
          acc_bits -= 8;
        }
      }
    }
  }
  if (acc_bits > 0) {
    if (w >= out_cap) return kErrOutputFull;
    out[w++] = static_cast<uint8_t>((acc << (8 - acc_bits)) & 0xFF);
  }
  *nbits_out = nbits;
  return static_cast<int64_t>(w);
}

// Decode + re-block straight into the packed-u16 layout (pad_width is in
// PAIR slots here, not symbol slots).  Streams whose pairs cannot be
// represented (count > 64, |value| > 511) return kErrBadInput and the
// caller falls back to the int32 path.
int64_t huff_unpack_pairs16(const uint8_t* packed, uint64_t nbits,
                            const uint8_t* lengths, const int32_t* symbols,
                            size_t num_symbols, int64_t block_size,
                            int64_t num_blocks, int64_t pad_width,
                            uint16_t* out_pairs, int32_t* out_lengths) {
  if (num_symbols == 0) return nbits == 0 ? 0 : kErrBadInput;
  uint32_t first_code[33] = {0};
  int32_t first_index[33];
  uint32_t count_len[33] = {0};
  for (int l = 0; l <= 32; ++l) first_index[l] = -1;
  for (size_t s = 0; s < num_symbols; ++s) {
    int l = lengths[s];
    if (l < 1 || l > 32) return kErrBadInput;
    if (first_index[l] < 0) first_index[l] = static_cast<int32_t>(s);
    ++count_len[l];
  }
  uint32_t code = 0;
  int prev = 0;
  for (int l = 1; l <= 32; ++l) {
    if (!count_len[l]) continue;
    code <<= (l - prev);
    prev = l;
    first_code[l] = code;
    code += count_len[l];
  }
  int64_t cum = 0, cur_block = -1, cur_slot = 0, n_sym = 0;
  int32_t pending_count = 0;
  bool have_count = false;
  uint32_t acc = 0;
  int acc_len = 0;
  for (uint64_t i = 0; i < nbits; ++i) {
    acc = (acc << 1) | ((packed[i >> 3] >> (7 - (i & 7))) & 1);
    ++acc_len;
    if (acc_len > 32) return kErrBadInput;
    if (count_len[acc_len] &&
        acc - first_code[acc_len] < count_len[acc_len]) {
      int32_t sym =
          symbols[first_index[acc_len] + (acc - first_code[acc_len])];
      acc = 0;
      acc_len = 0;
      ++n_sym;
      if (!have_count) {
        if (sym <= 0 || sym > 64) return kErrBadInput;
        pending_count = sym;
        have_count = true;
        continue;
      }
      have_count = false;
      if (sym < -512 || sym > 511) return kErrBadInput;
      cum += pending_count;
      int64_t blk = (cum - 1) / block_size;
      if (blk < 0 || blk >= num_blocks) return kErrBadInput;
      if (blk != cur_block) {
        if (blk < cur_block) return kErrBadInput;
        cur_block = blk;
        cur_slot = 0;
      }
      if (cur_slot >= pad_width) return kErrBadInput;
      out_pairs[blk * pad_width + cur_slot] =
          static_cast<uint16_t>(((pending_count - 1) << 10) |
                                (sym + 512));
      out_lengths[blk] += 2;
      ++cur_slot;
    }
  }
  if (acc_len != 0 || have_count) return kErrBadInput;
  return n_sym;
}

// ---- sparse-delta RLE layout (sparse16) ------------------------------
// ops/rle.py::rle_encode_sparse16: slot m holds (value - prev_value) +
// 1024 at run starts (prev_value := 0 at slot 0), 0 elsewhere.  The
// device ships ONE combined (N, stride) buffer (64 luma + 32 Cr + 32 Cb
// lanes per block, ops/pallas_fwd.py), so every pass below takes a row
// stride and a column offset and walks the channel in place — no
// per-channel host copies.  Symbols are reconstructed as the same
// [count, value] stream the pair layout carries (count = gap to the
// next start; the last run extends to row_len).

}  // extern "C"  (template helper below needs C++ linkage)

// Shared walker: calls fn(count, value) for each run of one row.
// Returns the number of runs, or a negative error.
template <typename Fn>
static inline int64_t walk_sparse16_row(const uint16_t* row, size_t row_len,
                                        Fn&& fn) {
  if (row_len == 0 || row[0] == 0) return kErrBadInput;  // slot 0 = start
  int64_t runs = 0;
  int32_t value = 0;
  size_t start = 0;
  int32_t pending = 0;
  for (size_t m = 0; m < row_len; ++m) {
    uint16_t w = row[m];
    if (w == 0) continue;
    if (w < 2 || w > 2046) return kErrBadInput;  // biased delta range
    if (m > 0) {
      if (!fn(static_cast<int32_t>(m - start), pending)) return kErrOutputFull;
      ++runs;
    }
    value += static_cast<int32_t>(w) - 1024;
    if (value < -512 || value > 511) return kErrBadInput;
    pending = value;
    start = m;
  }
  if (!fn(static_cast<int32_t>(row_len - start), pending)) return kErrOutputFull;
  return runs + 1;
}

extern "C" {

int64_t rle_symbol_hist_sparse16(const uint16_t* sparse, size_t n_rows,
                                 size_t row_len, size_t stride,
                                 size_t col_off, int64_t offset,
                                 int64_t* counts, size_t nbins,
                                 int32_t* out_lengths) {
  int64_t total = 0;
  for (size_t r = 0; r < n_rows; ++r) {
    const uint16_t* row = sparse + r * stride + col_off;
    bool bad = false;
    int64_t runs = walk_sparse16_row(row, row_len, [&](int32_t c, int32_t v) {
      int64_t cb = static_cast<int64_t>(c) + offset;
      int64_t vb = static_cast<int64_t>(v) + offset;
      if (cb < 0 || cb >= static_cast<int64_t>(nbins) || vb < 0 ||
          vb >= static_cast<int64_t>(nbins)) {
        bad = true;
        return false;
      }
      ++counts[cb];
      ++counts[vb];
      return true;
    });
    if (runs < 0 || bad) return kErrBadInput;
    if (out_lengths) out_lengths[r] = static_cast<int32_t>(2 * runs);
    total += 2 * runs;
  }
  return total;
}

int64_t huff_pack_sparse16(const uint16_t* sparse, size_t n_rows,
                           size_t row_len, size_t stride, size_t col_off,
                           int64_t lut_base, const uint32_t* lut_codes,
                           const uint8_t* lut_lens, size_t lut_size,
                           uint8_t* out, size_t out_cap,
                           uint64_t* nbits_out) {
  uint64_t acc = 0;
  int acc_bits = 0;
  size_t w = 0;
  uint64_t nbits = 0;
  bool full = false, bad = false;
  for (size_t r = 0; r < n_rows; ++r) {
    const uint16_t* row = sparse + r * stride + col_off;
    int64_t runs = walk_sparse16_row(row, row_len, [&](int32_t c, int32_t v) {
      int32_t cv[2] = {c, v};
      for (int s = 0; s < 2; ++s) {
        int64_t idx = static_cast<int64_t>(cv[s]) - lut_base;
        if (idx < 0 || idx >= static_cast<int64_t>(lut_size)) {
          bad = true;
          return false;
        }
        int len = lut_lens[idx];
        if (len < 1 || len > 32) {
          bad = true;
          return false;
        }
        acc = (acc << len) | lut_codes[idx];
        acc_bits += len;
        nbits += len;
        while (acc_bits >= 8) {
          if (w >= out_cap) {
            full = true;
            return false;
          }
          out[w++] = static_cast<uint8_t>(acc >> (acc_bits - 8));
          acc_bits -= 8;
        }
      }
      return true;
    });
    // full must be checked first: an output-full abort also makes the
    // walker return negative, and misreporting it as bad-input would
    // misdirect debugging toward stream corruption.
    if (full) return kErrOutputFull;
    if (bad || runs < 0) return kErrBadInput;
  }
  if (acc_bits > 0) {
    if (w >= out_cap) return kErrOutputFull;
    out[w++] = static_cast<uint8_t>((acc << (8 - acc_bits)) & 0xFF);
  }
  *nbits_out = nbits;
  return static_cast<int64_t>(w);
}

// Decode straight into the sparse-delta layout (the h2d-ready device
// decode input).  block_size == row_len for sparse16 (runs always cover
// the block); runs may not span blocks.
int64_t huff_unpack_sparse16(const uint8_t* packed, uint64_t nbits,
                             const uint8_t* lengths, const int32_t* symbols,
                             size_t num_symbols, int64_t block_size,
                             int64_t num_blocks, size_t stride,
                             size_t col_off, uint16_t* out_sparse,
                             int32_t* out_lengths) {
  if (num_symbols == 0) return nbits == 0 ? 0 : kErrBadInput;
  uint32_t first_code[33] = {0};
  int32_t first_index[33];
  uint32_t count_len[33] = {0};
  for (int l = 0; l <= 32; ++l) first_index[l] = -1;
  for (size_t s = 0; s < num_symbols; ++s) {
    int l = lengths[s];
    if (l < 1 || l > 32) return kErrBadInput;
    if (first_index[l] < 0) first_index[l] = static_cast<int32_t>(s);
    ++count_len[l];
  }
  uint32_t code = 0;
  int prev = 0;
  for (int l = 1; l <= 32; ++l) {
    if (!count_len[l]) continue;
    code <<= (l - prev);
    prev = l;
    first_code[l] = code;
    code += count_len[l];
  }
  int64_t pos = 0;  // global position over num_blocks * block_size
  int32_t prev_value = 0;
  int64_t n_sym = 0;
  int32_t pending_count = 0;
  bool have_count = false;
  uint32_t acc = 0;
  int acc_len = 0;
  for (uint64_t i = 0; i < nbits; ++i) {
    acc = (acc << 1) | ((packed[i >> 3] >> (7 - (i & 7))) & 1);
    ++acc_len;
    if (acc_len > 32) return kErrBadInput;
    if (count_len[acc_len] &&
        acc - first_code[acc_len] < count_len[acc_len]) {
      int32_t sym =
          symbols[first_index[acc_len] + (acc - first_code[acc_len])];
      acc = 0;
      acc_len = 0;
      ++n_sym;
      if (!have_count) {
        if (sym <= 0 || sym > block_size) return kErrBadInput;
        pending_count = sym;
        have_count = true;
        continue;
      }
      have_count = false;
      if (sym < -512 || sym > 511) return kErrBadInput;
      int64_t blk = pos / block_size;
      int64_t slot = pos % block_size;
      if (blk >= num_blocks) return kErrBadInput;
      // runs may not cross block boundaries
      if (slot + pending_count > block_size) return kErrBadInput;
      if (slot == 0) prev_value = 0;
      int32_t delta = sym - prev_value;
      out_sparse[blk * stride + col_off + slot] =
          static_cast<uint16_t>(delta + 1024);
      prev_value = sym;
      if (out_lengths) out_lengths[blk] += 2;
      pos += pending_count;
    }
  }
  if (acc_len != 0 || have_count) return kErrBadInput;
  if (pos != num_blocks * block_size) return kErrBadInput;
  return n_sym;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Per-block parity-mode Huffman (reference JPEG.c:844-1097 semantics).
//
// Exact behavioral twin of oracle/jpeg_oracle.py::encode_huffman_oracle —
// first-seen-order frequency pairs (calculate_frequency, JPEG.c:864-885),
// the array min-heap with its missing sift-up on re-insertion
// (build_heap/build_huffman_tree, :913-961; tree shapes depend on the
// quirk), and DFS left='0'/right='1' code assignment (:963-982).  Emits the
// same ASCII '0'/'1' bitstrings the oracle produces, so the parity-mode
// pipeline scales to the reference's largest experiment sizes without the
// interpreted per-block heap loop.
// ---------------------------------------------------------------------------

namespace perblock {

struct HNode {
  long long count;
  int value;  // symbol + 1000, or -1 for internal
  int left;   // pool indices, -1 = none
  int right;
};

constexpr int kSymOffset = 8192;   // lookup table offset for symbol values
constexpr int kInternal = INT32_MIN;  // internal-node marker
constexpr int kSymRange = 32768;

// Recursive sift-down by strict count comparison (JPEG.c heapify).
inline void heapify(std::vector<HNode>& pool, std::vector<int>& heap,
                    int size, int i) {
  int smallest = i;
  int l = 2 * i + 1, r = 2 * i + 2;
  if (l < size && pool[heap[l]].count < pool[heap[smallest]].count)
    smallest = l;
  if (r < size && pool[heap[r]].count < pool[heap[smallest]].count)
    smallest = r;
  if (smallest != i) {
    std::swap(heap[i], heap[smallest]);
    heapify(pool, heap, size, smallest);
  }
}

// DFS code assignment; appends the block's ASCII bits for each symbol via
// a per-symbol code table.  Returns false on out-of-range symbols.
inline bool encode_block(const int32_t* symbols, int64_t n,
                         std::vector<HNode>& pool, std::vector<int>& heap,
                         std::vector<int>& seen, std::vector<long long>& cnt,
                         std::vector<std::string>& codes,
                         std::string& out_bits) {
  if (n <= 0) return true;  // empty block: empty bitstring (like the oracle)
  pool.clear();
  heap.clear();
  // First-seen-order frequency pairs.
  std::vector<int> order;
  for (int64_t k = 0; k < n; ++k) {
    long long v = static_cast<long long>(symbols[k]) + 1000;
    // v == -1 is the reference's internal-node marker — its tree walk is
    // undefined there (symbol -1001); refuse rather than diverge.
    if (v == -1 || v < -kSymOffset + 1 || v >= kSymRange - kSymOffset)
      return false;
    int idx = static_cast<int>(v) + kSymOffset;
    if (seen[idx] < 0) {
      seen[idx] = static_cast<int>(order.size());
      order.push_back(idx);
      cnt[idx] = 0;
    }
    ++cnt[idx];
  }
  for (int idx : order) {
    HNode nnode;
    nnode.count = cnt[idx];
    nnode.value = idx - kSymOffset;
    nnode.left = nnode.right = -1;
    heap.push_back(static_cast<int>(pool.size()));
    pool.push_back(nnode);
  }
  int size = static_cast<int>(heap.size());
  for (int i = size / 2 - 1; i >= 0; --i) heapify(pool, heap, size, i);
  while (size > 1) {
    // left = copy of heap[0]; pop.
    int left = static_cast<int>(pool.size());
    pool.push_back(pool[heap[0]]);
    --size;
    heap[0] = heap[size];
    heapify(pool, heap, size, 0);
    int right = static_cast<int>(pool.size());
    pool.push_back(pool[heap[0]]);
    --size;
    heap[0] = heap[size];
    heapify(pool, heap, size, 0);
    HNode parent;
    parent.count = pool[left].count + pool[right].count;
    parent.value = kInternal;  // sentinel no symbol+1000 can reach
    parent.left = left;
    parent.right = right;
    int pi = static_cast<int>(pool.size());
    pool.push_back(parent);
    if (size < static_cast<int>(heap.size()))
      heap[size] = pi;
    else
      heap.push_back(pi);
    ++size;
    // The reference's re-insert "heapify" runs at the new LEAF index — a
    // sift-down there is a no-op; reproduced faithfully (the quirk).
    heapify(pool, heap, size, size - 1);
  }
  // DFS code assignment (iterative to bound stack depth).
  for (int idx : order) codes[idx].clear();
  struct Frame { int node; std::string prefix; };
  std::vector<Frame> stack;
  stack.push_back({heap[0], std::string()});
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const HNode& nd = pool[f.node];
    if (nd.value != kInternal) {
      codes[nd.value + kSymOffset] = f.prefix;
      continue;
    }
    // DFS order: left fully before right → push right first.
    stack.push_back({nd.right, f.prefix + "1"});
    stack.push_back({nd.left, f.prefix + "0"});
  }
  for (int64_t k = 0; k < n; ++k)
    out_bits += codes[static_cast<int>(symbols[k]) + 1000 + kSymOffset];
  for (int idx : order) seen[idx] = -1;  // reset for the next block
  return true;
}

}  // namespace perblock

extern "C" {

// Batched per-block parity Huffman: `pairs` is the padded (N, pad_width)
// int32 RLE symbol matrix, `lengths` the valid symbol count per block.
// Emits each block's ASCII '0'/'1' bitstring concatenated into `out`
// (capacity `cap`) with per-block character counts in `bit_counts`.
// Returns total characters written, or <0 (kErrOutputFull on capacity,
// kErrBadInput on out-of-range symbols → caller falls back to Python).
int64_t huff_per_block_ascii(const int32_t* pairs, const int32_t* lengths,
                             int64_t n_blocks, int64_t pad_width,
                             char* out, size_t cap, int64_t* bit_counts) {
  std::vector<perblock::HNode> pool;
  std::vector<int> heap;
  std::vector<int> seen(perblock::kSymRange, -1);
  std::vector<long long> cnt(perblock::kSymRange, 0);
  std::vector<std::string> codes(perblock::kSymRange);
  std::string bits;
  size_t w = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    bits.clear();
    int64_t n = lengths[b];
    if (n < 0 || n > pad_width) return kErrBadInput;
    if (!perblock::encode_block(pairs + b * pad_width, n, pool, heap, seen,
                                cnt, codes, bits))
      return kErrBadInput;
    if (w + bits.size() > cap) return kErrOutputFull;
    std::memcpy(out + w, bits.data(), bits.size());
    w += bits.size();
    bit_counts[b] = static_cast<int64_t>(bits.size());
  }
  return static_cast<int64_t>(w);
}

}  // extern "C"
