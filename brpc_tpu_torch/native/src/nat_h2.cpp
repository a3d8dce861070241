// Native h2/gRPC server-side lane — h2 framing + HPACK in the native cut
// loop, gRPC messages de-framed and handed to Python usercode (kind-4
// py-lane requests) or to registered native handlers, responses framed
// natively with static-table HPACK and h2 flow control.
//
// Reference shape: policy/http2_rpc_protocol.cpp (frame layer, stream
// state, flow control) + details/hpack.cpp (RFC 7541). The encoder is
// static-index + literal-without-indexing — a legal choice that keeps the
// peer's dynamic table untouched, so responses from concurrent py-lane
// pthreads need no shared encoder state (the Python lane's
// brpc_tpu/rpc/hpack.py makes the same choice).
#include "nat_internal.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// HPACK (RFC 7541)
// ---------------------------------------------------------------------------

struct StaticEntry {
  const char* name;
  const char* value;
};
// RFC 7541 Appendix A
static const StaticEntry kStatic[] = {
    {":authority", ""}, {":method", "GET"}, {":method", "POST"},
    {":path", "/"}, {":path", "/index.html"}, {":scheme", "http"},
    {":scheme", "https"}, {":status", "200"}, {":status", "204"},
    {":status", "206"}, {":status", "304"}, {":status", "400"},
    {":status", "404"}, {":status", "500"}, {"accept-charset", ""},
    {"accept-encoding", "gzip, deflate"}, {"accept-language", ""},
    {"accept-ranges", ""}, {"accept", ""},
    {"access-control-allow-origin", ""}, {"age", ""}, {"allow", ""},
    {"authorization", ""}, {"cache-control", ""},
    {"content-disposition", ""}, {"content-encoding", ""},
    {"content-language", ""}, {"content-length", ""},
    {"content-location", ""}, {"content-range", ""}, {"content-type", ""},
    {"cookie", ""}, {"date", ""}, {"etag", ""}, {"expect", ""},
    {"expires", ""}, {"from", ""}, {"host", ""}, {"if-match", ""},
    {"if-modified-since", ""}, {"if-none-match", ""}, {"if-range", ""},
    {"if-unmodified-since", ""}, {"last-modified", ""}, {"link", ""},
    {"location", ""}, {"max-forwards", ""}, {"proxy-authenticate", ""},
    {"proxy-authorization", ""}, {"range", ""}, {"referer", ""},
    {"refresh", ""}, {"retry-after", ""}, {"server", ""},
    {"set-cookie", ""}, {"strict-transport-security", ""},
    {"transfer-encoding", ""}, {"user-agent", ""}, {"vary", ""},
    {"via", ""}, {"www-authenticate", ""},
};
static const int kStaticCount = (int)(sizeof(kStatic) / sizeof(kStatic[0]));

// RFC 7541 Appendix B — Huffman (code, bits) for symbols 0..255
static const struct {
  uint32_t code;
  uint8_t bits;
} kHuff[] = {
    {0x1ff8, 13}, {0x7fffd8, 23}, {0xfffffe2, 28}, {0xfffffe3, 28},
    {0xfffffe4, 28}, {0xfffffe5, 28}, {0xfffffe6, 28}, {0xfffffe7, 28},
    {0xfffffe8, 28}, {0xffffea, 24}, {0x3ffffffc, 30}, {0xfffffe9, 28},
    {0xfffffea, 28}, {0x3ffffffd, 30}, {0xfffffeb, 28}, {0xfffffec, 28},
    {0xfffffed, 28}, {0xfffffee, 28}, {0xfffffef, 28}, {0xffffff0, 28},
    {0xffffff1, 28}, {0xffffff2, 28}, {0x3ffffffe, 30}, {0xffffff3, 28},
    {0xffffff4, 28}, {0xffffff5, 28}, {0xffffff6, 28}, {0xffffff7, 28},
    {0xffffff8, 28}, {0xffffff9, 28}, {0xffffffa, 28}, {0xffffffb, 28},
    {0x14, 6}, {0x3f8, 10}, {0x3f9, 10}, {0xffa, 12}, {0x1ff9, 13},
    {0x15, 6}, {0xf8, 8}, {0x7fa, 11}, {0x3fa, 10}, {0x3fb, 10},
    {0xf9, 8}, {0x7fb, 11}, {0xfa, 8}, {0x16, 6}, {0x17, 6}, {0x18, 6},
    {0x0, 5}, {0x1, 5}, {0x2, 5}, {0x19, 6}, {0x1a, 6}, {0x1b, 6},
    {0x1c, 6}, {0x1d, 6}, {0x1e, 6}, {0x1f, 6}, {0x5c, 7}, {0xfb, 8},
    {0x7ffc, 15}, {0x20, 6}, {0xffb, 12}, {0x3fc, 10}, {0x1ffa, 13},
    {0x21, 6}, {0x5d, 7}, {0x5e, 7}, {0x5f, 7}, {0x60, 7}, {0x61, 7},
    {0x62, 7}, {0x63, 7}, {0x64, 7}, {0x65, 7}, {0x66, 7}, {0x67, 7},
    {0x68, 7}, {0x69, 7}, {0x6a, 7}, {0x6b, 7}, {0x6c, 7}, {0x6d, 7},
    {0x6e, 7}, {0x6f, 7}, {0x70, 7}, {0x71, 7}, {0x72, 7}, {0xfc, 8},
    {0x73, 7}, {0xfd, 8}, {0x1ffb, 13}, {0x7fff0, 19}, {0x1ffc, 13},
    {0x3ffc, 14}, {0x22, 6}, {0x7ffd, 15}, {0x3, 5}, {0x23, 6}, {0x4, 5},
    {0x24, 6}, {0x5, 5}, {0x25, 6}, {0x26, 6}, {0x27, 6}, {0x6, 5},
    {0x74, 7}, {0x75, 7}, {0x28, 6}, {0x29, 6}, {0x2a, 6}, {0x7, 5},
    {0x2b, 6}, {0x76, 7}, {0x2c, 6}, {0x8, 5}, {0x9, 5}, {0x2d, 6},
    {0x77, 7}, {0x78, 7}, {0x79, 7}, {0x7a, 7}, {0x7b, 7}, {0x7ffe, 15},
    {0x7fc, 11}, {0x3ffd, 14}, {0x1ffd, 13}, {0xffffffc, 28},
    {0xfffe6, 20}, {0x3fffd2, 22}, {0xfffe7, 20}, {0xfffe8, 20},
    {0x3fffd3, 22}, {0x3fffd4, 22}, {0x3fffd5, 22}, {0x7fffd9, 23},
    {0x3fffd6, 22}, {0x7fffda, 23}, {0x7fffdb, 23}, {0x7fffdc, 23},
    {0x7fffdd, 23}, {0x7fffde, 23}, {0xffffeb, 24}, {0x7fffdf, 23},
    {0xffffec, 24}, {0xffffed, 24}, {0x3fffd7, 22}, {0x7fffe0, 23},
    {0xffffee, 24}, {0x7fffe1, 23}, {0x7fffe2, 23}, {0x7fffe3, 23},
    {0x7fffe4, 23}, {0x1fffdc, 21}, {0x3fffd8, 22}, {0x7fffe5, 23},
    {0x3fffd9, 22}, {0x7fffe6, 23}, {0x7fffe7, 23}, {0xffffef, 24},
    {0x3fffda, 22}, {0x1fffdd, 21}, {0xfffe9, 20}, {0x3fffdb, 22},
    {0x3fffdc, 22}, {0x7fffe8, 23}, {0x7fffe9, 23}, {0x1fffde, 21},
    {0x7fffea, 23}, {0x3fffdd, 22}, {0x3fffde, 22}, {0xfffff0, 24},
    {0x1fffdf, 21}, {0x3fffdf, 22}, {0x7fffeb, 23}, {0x7fffec, 23},
    {0x1fffe0, 21}, {0x1fffe1, 21}, {0x3fffe0, 22}, {0x1fffe2, 21},
    {0x7fffed, 23}, {0x3fffe1, 22}, {0x7fffee, 23}, {0x7fffef, 23},
    {0xfffea, 20}, {0x3fffe2, 22}, {0x3fffe3, 22}, {0x3fffe4, 22},
    {0x7ffff0, 23}, {0x3fffe5, 22}, {0x3fffe6, 22}, {0x7ffff1, 23},
    {0x3ffffe0, 26}, {0x3ffffe1, 26}, {0xfffeb, 20}, {0x7fff1, 19},
    {0x3fffe7, 22}, {0x7ffff2, 23}, {0x3fffe8, 22}, {0x1ffffec, 25},
    {0x3ffffe2, 26}, {0x3ffffe3, 26}, {0x3ffffe4, 26}, {0x7ffffde, 27},
    {0x7ffffdf, 27}, {0x3ffffe5, 26}, {0xfffff1, 24}, {0x1ffffed, 25},
    {0x7fff2, 19}, {0x1fffe3, 21}, {0x3ffffe6, 26}, {0x7ffffe0, 27},
    {0x7ffffe1, 27}, {0x3ffffe7, 26}, {0x7ffffe2, 27}, {0xfffff2, 24},
    {0x1fffe4, 21}, {0x1fffe5, 21}, {0x3ffffe8, 26}, {0x3ffffe9, 26},
    {0xffffffd, 28}, {0x7ffffe3, 27}, {0x7ffffe4, 27}, {0x7ffffe5, 27},
    {0xfffec, 20}, {0xfffff3, 24}, {0xfffed, 20}, {0x1fffe6, 21},
    {0x3fffe9, 22}, {0x1fffe7, 21}, {0x1fffe8, 21}, {0x7ffff3, 23},
    {0x3fffea, 22}, {0x3fffeb, 22}, {0x1ffffee, 25}, {0x1ffffef, 25},
    {0xfffff4, 24}, {0xfffff5, 24}, {0x3ffffea, 26}, {0x7ffff4, 23},
    {0x3ffffeb, 26}, {0x7ffffe6, 27}, {0x3ffffec, 26}, {0x3ffffed, 26},
    {0x7ffffe7, 27}, {0x7ffffe8, 27}, {0x7ffffe9, 27}, {0x7ffffea, 27},
    {0x7ffffeb, 27}, {0xffffffe, 28}, {0x7ffffec, 27}, {0x7ffffed, 27},
    {0x7ffffee, 27}, {0x7ffffef, 27}, {0x7fffff0, 27}, {0x3ffffee, 26},
};

// Huffman decode trie, built once: node -> {child0, child1, symbol}
struct HuffNode {
  int16_t next[2] = {-1, -1};
  int16_t sym = -1;
};
static std::vector<HuffNode> g_huff_trie;
static void huff_init() {
  g_huff_trie.clear();
  g_huff_trie.emplace_back();
  for (int sym = 0; sym < 256; sym++) {
    uint32_t code = kHuff[sym].code;
    int bits = kHuff[sym].bits;
    int node = 0;
    for (int i = bits - 1; i >= 0; i--) {
      int bit = (code >> i) & 1;
      if (g_huff_trie[node].next[bit] < 0) {
        g_huff_trie[node].next[bit] = (int16_t)g_huff_trie.size();
        g_huff_trie.emplace_back();
      }
      node = g_huff_trie[node].next[bit];
    }
    g_huff_trie[node].sym = (int16_t)sym;
  }
}
static std::once_flag g_huff_once;

static bool huff_decode(const uint8_t* data, size_t n, std::string* out) {
  std::call_once(g_huff_once, huff_init);
  int node = 0;
  int padding = 0;
  bool pad_ones = true;
  for (size_t i = 0; i < n; i++) {
    uint8_t b = data[i];
    for (int j = 7; j >= 0; j--) {
      int bit = (b >> j) & 1;
      int nxt = g_huff_trie[node].next[bit];
      if (nxt < 0) return false;
      node = nxt;
      if (g_huff_trie[node].sym >= 0) {
        out->push_back((char)g_huff_trie[node].sym);
        node = 0;
        padding = 0;
        pad_ones = true;
      } else {
        padding++;
        if (bit == 0) pad_ones = false;
      }
    }
  }
  if (padding > 7) return false;
  if (padding && !pad_ones) return false;  // must be an EOS prefix
  return true;
}

// RFC 7541 §5.1 integer; returns false on truncation or on a value past
// kHpIntMax. Every integer this decoder yields is a string length, a
// table index or a table-size update: lengths are bounded by the header
// block (≤ kMaxHeaderBlock), indices by the table, size updates by the
// 4096 clamp in decode() — a continuation-encoded value past 2^24 is an
// attack or corruption, never a legal header, so reject it here rather
// than letting a 56-bit length reach the callers' arithmetic.
static constexpr uint64_t kHpIntMax = 1u << 24;
static bool hp_int(const uint8_t* d, size_t n, size_t* pos, int prefix,
                   uint64_t* out) {
  if (*pos >= n) return false;
  uint64_t limit = (1u << prefix) - 1;
  uint64_t v = NAT_WIRE(d[*pos] & limit);
  (*pos)++;
  if (v < limit) {
    *out = v;
    return true;
  }
  int shift = 0;
  while (true) {
    if (*pos >= n || shift > 56) return false;
    uint8_t b = d[*pos];
    (*pos)++;
    v += (uint64_t)(b & 0x7f) << shift;
    shift += 7;
    if (!(b & 0x80)) {
      if (v > kHpIntMax) return false;  // wire-int clamp (wiretrust)
      *out = v;
      return true;
    }
  }
}

static bool hp_str(const uint8_t* d, size_t n, size_t* pos,
                   std::string* out) {
  if (*pos >= n) return false;
  bool huff = (d[*pos] & 0x80) != 0;
  uint64_t len;
  if (!hp_int(d, n, pos, 7, &len)) return false;
  if (*pos + len > n) return false;
  if (huff) {
    if (!huff_decode(d + *pos, len, out)) return false;
  } else {
    out->append((const char*)(d + *pos), len);
  }
  *pos += len;
  return true;
}

// Full decoder: static + dynamic table + huffman + size updates.
class HpackDecoderN {
 public:
  // Decodes a header block; each header appended to `flat` as
  // "name: value\n" (names arrive lowercased per h2). :path is also
  // surfaced separately for dispatch.
  // natcheck:wire: d — HPACK block bytes straight from frame payloads
  bool decode(const uint8_t* d, size_t n, std::string* flat,
              std::string* path) {
    size_t pos = 0;
    while (pos < n) {
      uint8_t b = d[pos];
      std::string name, value;
      if (b & 0x80) {  // indexed
        uint64_t idx;
        if (!hp_int(d, n, &pos, 7, &idx)) return false;
        if (!entry(idx, &name, &value)) return false;
      } else if (b & 0x40) {  // literal + incremental indexing
        uint64_t idx;
        if (!hp_int(d, n, &pos, 6, &idx)) return false;
        if (idx != 0) {
          std::string dummy;
          if (!entry(idx, &name, &dummy)) return false;
        } else if (!hp_str(d, n, &pos, &name)) {
          return false;
        }
        if (!hp_str(d, n, &pos, &value)) return false;
        add(name, value);
      } else if (b & 0x20) {  // dynamic table size update
        uint64_t sz;
        if (!hp_int(d, n, &pos, 5, &sz)) return false;
        // we never advertise SETTINGS_HEADER_TABLE_SIZE, so the peer's
        // update must stay within the 4096 default (RFC 7541 §6.3) —
        // clamping also caps per-connection memory against a client
        // announcing a huge table and filling it
        max_size_ = sz > 4096 ? 4096 : (size_t)sz;
        evict();
        continue;
      } else {  // literal without indexing / never indexed
        uint64_t idx;
        if (!hp_int(d, n, &pos, 4, &idx)) return false;
        if (idx != 0) {
          std::string dummy;
          if (!entry(idx, &name, &dummy)) return false;
        } else if (!hp_str(d, n, &pos, &name)) {
          return false;
        }
        if (!hp_str(d, n, &pos, &value)) return false;
      }
      if (path != nullptr && name == ":path") *path = value;
      flat->append(name);
      flat->append(": ");
      flat->append(value);
      flat->push_back('\n');
    }
    return true;
  }

 private:
  std::deque<std::pair<std::string, std::string>> dyn_;
  size_t size_ = 0;
  size_t max_size_ = 4096;

  bool entry(uint64_t idx, std::string* name, std::string* value) {
    if (idx == 0) return false;
    if (idx <= (uint64_t)kStaticCount) {
      *name = kStatic[idx - 1].name;
      *value = kStatic[idx - 1].value;
      return true;
    }
    size_t di = (size_t)(idx - kStaticCount - 1);
    if (di >= dyn_.size()) return false;
    *name = dyn_[di].first;
    *value = dyn_[di].second;
    return true;
  }

  void add(const std::string& name, const std::string& value) {
    dyn_.emplace_front(name, value);
    size_ += name.size() + value.size() + 32;
    evict();
  }

  void evict() {
    while (size_ > max_size_ && !dyn_.empty()) {
      size_ -= dyn_.back().first.size() + dyn_.back().second.size() + 32;
      dyn_.pop_back();
    }
  }
};

// Static-only encoder primitives (stateless — safe from any thread;
// shared with the bench client via nat_internal.h).
void hp_enc_int(std::string* out, uint64_t v, int prefix,
                uint8_t first) {
  uint64_t limit = (1u << prefix) - 1;
  if (v < limit) {
    out->push_back((char)(first | v));
    return;
  }
  out->push_back((char)(first | limit));
  v -= limit;
  while (v >= 128) {
    out->push_back((char)((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back((char)v);
}

void hp_enc_str(std::string* out, std::string_view s) {
  hp_enc_int(out, s.size(), 7, 0x00);
  out->append(s.data(), s.size());
}

// literal-without-indexing with a static name index when available
void hp_enc_header(std::string* out, std::string_view name,
                   std::string_view value) {
  for (int i = 0; i < kStaticCount; i++) {
    if (name == kStatic[i].name) {
      if (value == kStatic[i].value) {
        hp_enc_int(out, i + 1, 7, 0x80);  // fully indexed
        return;
      }
      hp_enc_int(out, i + 1, 4, 0x00);  // indexed name
      hp_enc_str(out, value);
      return;
    }
  }
  out->push_back('\x00');
  hp_enc_str(out, name);
  hp_enc_str(out, value);
}

// ---------------------------------------------------------------------------
// h2 session
// ---------------------------------------------------------------------------

static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
static const size_t kPrefaceLen = 24;
// Per-connection resource bounds (the reference enforces
// MAX_CONCURRENT_STREAMS / header-size limits in its H2Context)
static const size_t kMaxConcurrentStreams = 1024;
static const size_t kMaxHeaderBlock = 1u << 20;

enum H2FrameType : uint8_t {
  kFData = 0,
  kFHeaders = 1,
  kFPriority = 2,
  kFRstStream = 3,
  kFSettings = 4,
  kFPushPromise = 5,
  kFPing = 6,
  kFGoaway = 7,
  kFWindowUpdate = 8,
  kFContinuation = 9,
};
static const uint8_t kFlagEndStream = 0x1;
static const uint8_t kFlagAck = 0x1;
static const uint8_t kFlagEndHeaders = 0x4;
static const uint8_t kFlagPadded = 0x8;
static const uint8_t kFlagPriority = 0x20;

static void frame_header(std::string* out, size_t len, uint8_t type,
                         uint8_t flags, uint32_t sid) {
  out->push_back((char)((len >> 16) & 0xff));
  out->push_back((char)((len >> 8) & 0xff));
  out->push_back((char)(len & 0xff));
  out->push_back((char)type);
  out->push_back((char)flags);
  out->push_back((char)((sid >> 24) & 0x7f));
  out->push_back((char)((sid >> 16) & 0xff));
  out->push_back((char)((sid >> 8) & 0xff));
  out->push_back((char)(sid & 0xff));
}

struct H2StreamN {
  std::string flat_headers;  // "name: value\n"
  std::string path;
  std::string data;       // raw gRPC-framed body
  bool headers_done = false;
  bool end_stream = false;
  bool dispatched = false;  // usercode ran; later frames on the sid drop
  int64_t send_window = 65535;  // for OUR DATA on this stream
  uint64_t recv_ns = 0;  // HEADERS decoded (span timeline anchor)
};

// Encoder-side HPACK dynamic table (the reference keeps one in
// details/hpack.cpp). Blocks that ADD to or INDEX INTO this table must
// reach the wire in encoder-state order, so it is used ONLY for
// response HEADERS emitted on the reading thread (single-threaded,
// batch-ordered); py-thread responses and parked trailers stay on the
// state-independent static encoding and may interleave freely.
struct HpackEncTableN {
  struct Entry {
    std::string name, value;
  };
  std::deque<Entry> entries;  // front = newest
  size_t size = 0;
  // RFC 7541 §4.2 resize protocol: `max_size` is what the decoder
  // currently believes; when the peer's SETTINGS change the cap, the
  // next reading-thread block prefixes update(lowest-since-signal)
  // then update(target) if they differ (shrink-then-grow must signal
  // the minimum). py-thread static blocks cannot carry the update
  // (they are deliberately order-independent), so with a mid-stream
  // shrink an ultra-strict decoder may see the update one block late —
  // documented limitation; gRPC stacks do not resize mid-connection.
  size_t max_size = 4096;  // as signaled to (believed by) the decoder
  size_t lowest = 4096;    // min cap since the last signaled update
  size_t target = 4096;    // latest peer cap (≤4096)
  bool pending_resize = false;

  int find(std::string_view n, std::string_view v) const {
    for (size_t i = 0; i < entries.size(); i++) {
      if (entries[i].name == n && entries[i].value == v) {
        return (int)(kStaticCount + 1 + i);
      }
    }
    return -1;
  }
  void evict() {
    while (size > max_size && !entries.empty()) {
      size -= entries.back().name.size() + entries.back().value.size() + 32;
      entries.pop_back();
    }
  }
  void add(std::string_view n, std::string_view v) {
    size_t esz = n.size() + v.size() + 32;
    if (esz > max_size) {  // RFC 7541 §4.4: clears the table
      entries.clear();
      size = 0;
      return;
    }
    size += esz;
    evict();
    entries.push_front({std::string(n), std::string(v)});
  }
};

struct H2SessionN {
  HpackDecoderN dec;  // reading thread only
  // settings from the client (apply to frames WE send)
  int64_t peer_initial_window = 65535;
  size_t peer_max_frame = 16384;
  // encoder table for reading-thread response HEADERS (under mu)
  HpackEncTableN enc;
  // everything below is shared with py-lane responders: mu guards it
  NatMutex<kLockRankH2Sess> h2_mu;
  int64_t conn_send_window = 65535;
  std::map<uint32_t, H2StreamN> streams;
  // responses blocked on flow control: (sid, remaining DATA payload,
  // trailer block) flushed as WINDOW_UPDATEs arrive
  struct PendingSend {
    uint32_t sid;
    std::string data;      // remaining raw bytes for DATA frames
    std::string trailers;  // pre-framed trailer HEADERS (sent last)
  };
  std::deque<PendingSend> pending;
  // highest client-initiated stream id seen (under mu): the
  // last_stream_id a lame-duck GOAWAY promises to still serve
  uint32_t max_client_sid = 0;
  bool sent_goaway = false;  // quiesce emitted GOAWAY already (under mu)
  // CONTINUATION accumulation (reading thread only)
  uint32_t cont_sid = 0;
  bool cont_end_stream = false;
  bool cont_active = false;
  std::string cont_block;
};

int h2_sniff(const char* p, size_t n) {
  size_t cmp = n < kPrefaceLen ? n : kPrefaceLen;
  if (memcmp(p, kPreface, cmp) != 0) return 0;
  return n >= kPrefaceLen ? 1 : 2;
}

// Frame as many DATA bytes as the windows allow (requires h->h2_mu); the
// remainder stays in `data`. Appends frames to out.
static void h2_send_data_locked(H2SessionN* h, H2StreamN* st, uint32_t sid,
                                std::string* data, std::string* out) {
  while (!data->empty() && h->conn_send_window > 0 &&
         st->send_window > 0) {
    size_t chunk = data->size();
    if ((int64_t)chunk > h->conn_send_window) {
      chunk = (size_t)h->conn_send_window;
    }
    if ((int64_t)chunk > st->send_window) chunk = (size_t)st->send_window;
    if (chunk > h->peer_max_frame) chunk = h->peer_max_frame;
    frame_header(out, chunk, kFData, 0, sid);
    out->append(data->data(), chunk);
    data->erase(0, chunk);
    h->conn_send_window -= (int64_t)chunk;
    st->send_window -= (int64_t)chunk;
  }
}

// Complete gRPC response for a stream: response HEADERS + framed DATA +
// trailers (grpc-status). Flow-control leftovers park on the session.
// Called from the reading thread (native handlers, batch_out != nullptr)
// and from py pthreads (batch_out == nullptr).
// Encode one header with the session dynamic table (requires h->h2_mu;
// reading-thread blocks only — see HpackEncTableN).
static void hp_enc_header_dyn(H2SessionN* h, std::string* out,
                              std::string_view name,
                              std::string_view value) {
  if (h->enc.max_size > 0) {
    int idx = h->enc.find(name, value);
    if (idx > 0) {
      hp_enc_int(out, (uint64_t)idx, 7, 0x80);  // indexed (dynamic)
      return;
    }
  }
  if (h->enc.max_size == 0) {  // client forbade a dynamic table
    hp_enc_header(out, name, value);
    return;
  }
  // literal WITH incremental indexing: next response hits the index
  for (int i = 0; i < kStaticCount; i++) {
    if (name == kStatic[i].name) {
      hp_enc_int(out, (uint64_t)(i + 1), 6, 0x40);
      hp_enc_str(out, value);
      h->enc.add(name, value);
      return;
    }
  }
  out->push_back('\x40');
  hp_enc_str(out, name);
  hp_enc_str(out, value);
  h->enc.add(name, value);
}

// Emit the RFC 7541 §4.2 dynamic-table size update(s) owed after a
// SETTINGS_HEADER_TABLE_SIZE change, and settle the encoder bookkeeping.
// Requires h->h2_mu; the update bytes MUST lead the next header block that
// reaches the wire (whoever emits first — reading thread or py thread —
// carries them; see the pending_resize checks in h2_respond).
static void hp_emit_resize_locked(H2SessionN* h, std::string* out) {
  if (h->enc.lowest < h->enc.max_size) {
    hp_enc_int(out, h->enc.lowest, 5, 0x20);
    // the decoder evicts at `lowest` (a grow does NOT restore its
    // entries) — the encoder must drop the same entries or later
    // indexed refs point at ghosts
    h->enc.max_size = h->enc.lowest;
    h->enc.evict();
  }
  if (h->enc.target != h->enc.lowest) {
    hp_enc_int(out, h->enc.target, 5, 0x20);
  }
  h->enc.max_size = h->enc.target;
  h->enc.lowest = h->enc.target;
  h->enc.pending_resize = false;
  h->enc.evict();
}

static void h2_respond(NatSocket* s, uint32_t sid, const char* payload,
                       size_t payload_len, int grpc_status,
                       const char* grpc_message, IOBuf* batch_out) {
  H2SessionN* h = s->h2;
  if (h == nullptr) return;
  nat_counter_add(NS_H2_RESPONSES_OUT, 1);
  s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  // response headers: dynamic-table encoded on the reading thread
  // (wire-ordered), static-encoded from py threads (order-independent)
  std::string hdr_block;
  if (batch_out == nullptr) {
    hp_enc_int(&hdr_block, 8, 7, 0x80);  // :status 200 (static idx 8)
    hp_enc_header(&hdr_block, "content-type", "application/grpc");
  }
  std::string trailer_block;
  char stbuf[16];
  snprintf(stbuf, sizeof(stbuf), "%d", grpc_status);
  hp_enc_header(&trailer_block, "grpc-status", stbuf);
  if (grpc_message != nullptr && grpc_message[0] != '\0') {
    hp_enc_header(&trailer_block, "grpc-message", grpc_message);
  }
  // gRPC message framing: 1-byte compressed flag + 4-byte BE length
  std::string data;
  if (payload_len > 0 || grpc_status == 0) {
    data.reserve(5 + payload_len);
    data.push_back('\x00');
    data.push_back((char)((payload_len >> 24) & 0xff));
    data.push_back((char)((payload_len >> 16) & 0xff));
    data.push_back((char)((payload_len >> 8) & 0xff));
    data.push_back((char)(payload_len & 0xff));
    data.append(payload, payload_len);
  }
  std::string trailers;
  frame_header(&trailers, trailer_block.size(), kFHeaders,
               kFlagEndHeaders | kFlagEndStream, sid);
  trailers.append(trailer_block);

  std::string out;
  {
    std::lock_guard g(h->h2_mu);
    if (batch_out != nullptr) {
      // reading-thread block: encode under mu with the dynamic table
      if (h->enc.pending_resize) {  // peer changed the table cap
        hp_emit_resize_locked(h, &hdr_block);
      }
      hp_enc_int(&hdr_block, 8, 7, 0x80);  // :status 200
      hp_enc_header_dyn(h, &hdr_block, "content-type",
                        "application/grpc");
    } else if (h->enc.pending_resize) {
      // py-thread static block racing a pending resize: the §4.2 update
      // must lead the NEXT block on the wire, and this block (written
      // under mu, below) may well be it — carry the update at its front
      // instead of letting a strict decoder see a block with the update
      // missing (COMPRESSION_ERROR). Static encoding stays valid: the
      // update only evicts, it indexes nothing.
      std::string resize;
      hp_emit_resize_locked(h, &resize);
      hdr_block.insert(0, resize);
    }
    frame_header(&out, hdr_block.size(), kFHeaders, kFlagEndHeaders, sid);
    out.append(hdr_block);
    auto it = h->streams.find(sid);
    H2StreamN tmp;  // stream may already be gone (RST) — send anyway
    H2StreamN* st = it != h->streams.end() ? &it->second : &tmp;
    h2_send_data_locked(h, st, sid, &data, &out);
    if (!data.empty()) {
      // window exhausted: park the remainder + trailers; the
      // WINDOW_UPDATE path finishes the stream
      s->conn_parked_add(data.size() + trailers.size());
      h->pending.push_back({sid, std::move(data), std::move(trailers)});
      if (it != h->streams.end()) {
        // keep the stream entry alive for its send window
        it->second.data.clear();
        it->second.flat_headers.clear();
      }
    } else {
      out.append(trailers);
      if (it != h->streams.end()) h->streams.erase(it);
    }
    if (batch_out == nullptr) {
      // Write while still holding h->h2_mu: a WINDOW_UPDATE handled
      // concurrently by the reading thread flushes the parked remainder
      // under this same lock, so releasing before the write could put
      // DATA/trailers on the wire ahead of these HEADERS (the overtake
      // class 8ddf64e fixed for HTTP). Writes push under the sess mu
      // is the established order.
      IOBuf buf;
      buf.append(out.data(), out.size());
      s->write(std::move(buf));
    }
  }
  if (batch_out != nullptr) {
    batch_out->append(out.data(), out.size());
  }
}

// WINDOW_UPDATE arrived: flush parked responses that now fit. Requires
// h->h2_mu NOT held. Appends to out.
static void h2_flush_pending(NatSocket* s, H2SessionN* h, std::string* out) {
  std::lock_guard g(h->h2_mu);
  while (!h->pending.empty()) {
    auto& p = h->pending.front();
    auto it = h->streams.find(p.sid);
    H2StreamN tmp;
    H2StreamN* st = it != h->streams.end() ? &it->second : &tmp;
    size_t before = p.data.size();
    h2_send_data_locked(h, st, p.sid, &p.data, out);
    s->conn_parked_sub(before - p.data.size());
    if (!p.data.empty()) break;  // still blocked
    s->conn_parked_sub(p.trailers.size());
    out->append(p.trailers);
    if (it != h->streams.end()) h->streams.erase(it);
    h->pending.pop_front();
  }
}

// Trace context from a decoded flat header block ("name: value\n",
// names lowercased): the x-bd-trace-id / x-bd-span-id gRPC metadata the
// native client lane stamps (values hex, matching the HTTP lane).
static void trace_from_flat(const std::string& flat, uint64_t* trace_id,
                            uint64_t* parent_span) {
  size_t p = flat.find("x-bd-trace-id: ");
  if (p != std::string::npos && (p == 0 || flat[p - 1] == '\n')) {
    *trace_id = strtoull(flat.c_str() + p + 15, nullptr, 16);
  }
  p = flat.find("x-bd-span-id: ");
  if (p != std::string::npos && (p == 0 || flat[p - 1] == '\n')) {
    *parent_span = strtoull(flat.c_str() + p + 14, nullptr, 16);
  }
}

// A stream finished (END_STREAM): dispatch to a native handler
// ("/Service/Method" -> "Service.Method") or the py lane (kind 4).
static void h2_dispatch(NatSocket* s, H2SessionN* h, uint32_t sid,
                        IOBuf* batch_out) {
  NatServer* srv = s->server;
  std::string path, flat, data;
  uint64_t t_recv;
  {
    std::lock_guard g(h->h2_mu);
    auto it = h->streams.find(sid);
    if (it == h->streams.end()) return;
    if (it->second.dispatched) return;  // e.g. a second END_STREAM DATA
    it->second.dispatched = true;
    path = std::move(it->second.path);
    flat = std::move(it->second.flat_headers);
    data = std::move(it->second.data);
    t_recv = it->second.recv_ns;
    // entry stays (send windows) until the response goes out
  }
  srv->requests.fetch_add(1, std::memory_order_relaxed);
  nat_counter_add(NS_H2_MSGS_IN, 1);
  s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
  // native handler: "/EchoService/Echo" -> "EchoService.Echo"
  if (!srv->handlers.empty() && path.size() > 1) {
    size_t slash = path.find('/', 1);
    if (slash != std::string::npos) {
      char keybuf[256];
      size_t svc_len = slash - 1;
      size_t m_len = path.size() - slash - 1;
      if (svc_len + m_len + 1 <= sizeof(keybuf)) {
        memcpy(keybuf, path.data() + 1, svc_len);
        keybuf[svc_len] = '.';
        memcpy(keybuf + svc_len + 1, path.data() + slash + 1, m_len);
        const NativeHandler* hit = srv->find_handler(
            std::string_view(keybuf, svc_len + 1 + m_len));
        if (hit != nullptr) {
          // de-frame the (single, uncompressed) gRPC message
          IOBuf payload, attachment;
          bool framed_ok = false;
          if (data.size() >= 5 && data[0] == '\x00') {
            uint32_t mlen = rd_be32(data.data() + 1);
            if (5 + (size_t)mlen <= data.size()) {
              payload.append(data.data() + 5, mlen);
              framed_ok = true;
            }
          }
          uint64_t t_parse = nat_now_ns();
          uint32_t req_bytes = (uint32_t)payload.length();
          // flight-recorder tap: the DE-framed gRPC message (replay
          // re-frames it via nat_grpc_call) + the wire trace context.
          // An unframeable/compressed body is not replayable and
          // records nothing (the py-lane arm's guard, mirrored).
          if (framed_ok && nat_dump_enabled() && nat_dump_tick()) {
            uint64_t d_trace = 0, d_span = 0;
            trace_from_flat(flat, &d_trace, &d_span);
            nat_dump_sample_iobuf(NL_GRPC, "", 0, path.data(),
                                  path.size(), payload, d_trace, d_span);
          }
          // per-method row keyed by the gRPC :path
          int midx = nat_method_idx(NL_GRPC, path.data(), path.size());
          nat_method_begin(midx);
          NativeHandlerCtx ctx;
          ctx.req_payload = &payload;
          ctx.req_attachment = &attachment;
          (*hit)(ctx);
          uint64_t t_dispatch = nat_now_ns();
          std::string resp = ctx.resp_payload.to_string();
          h2_respond(s, sid, resp.data(), resp.size(),
                     ctx.error_code == 0 ? 0 : 2,
                     ctx.error_text.empty() ? nullptr
                                            : ctx.error_text.c_str(),
                     batch_out);
          uint64_t t_write = nat_now_ns();
          nat_lat_record(NL_GRPC, t_write - t_parse);
          nat_method_end(midx, t_write - t_parse, ctx.error_code != 0);
          if (nat_span_tick()) {
            uint64_t trace_id = 0, parent_span = 0;
            trace_from_flat(flat, &trace_id, &parent_span);
            nat_span_record(NL_GRPC, s->id, path.data(), path.size(),
                            t_recv != 0 ? t_recv : t_parse, t_parse,
                            t_dispatch, t_write, ctx.error_code, req_bytes,
                            (uint32_t)resp.size(), trace_id, parent_span);
          }
          return;
        }
      }
    }
  }
  if (!srv->py_lane_enabled) {
    h2_respond(s, sid, nullptr, 0, 12 /* UNIMPLEMENTED */,
               "no handler on native port", batch_out);
    return;
  }
  PyRequest* r = new PyRequest();
  r->kind = 4;
  r->sock_id = s->id;
  r->cid = (int64_t)sid;
  r->method = std::move(path);
  trace_from_flat(flat, &r->trace_id, &r->parent_span_id);
  r->meta_bytes = std::move(flat);
  r->payload = std::move(data);
  // flight-recorder tap, py-lane arm: de-frame the (single,
  // uncompressed) gRPC message like the handler arm — an unframeable
  // body is not replayable and records nothing
  if (nat_dump_enabled() && nat_dump_tick() && r->payload.size() >= 5 &&
      r->payload[0] == '\x00') {
    uint32_t mlen = rd_be32(r->payload.data() + 1);
    if (5 + (size_t)mlen <= r->payload.size()) {
      nat_dump_sample(NL_GRPC, "", 0, r->method.data(),
                      r->method.size(), nullptr, 0,
                      r->payload.data() + 5, mlen, r->trace_id,
                      r->parent_span_id);
    }
  }
  srv->enqueue_py(r);
}

// HEADERS/CONTINUATION block complete: decode + maybe dispatch.
static bool h2_headers_complete(NatSocket* s, H2SessionN* h, uint32_t sid,
                                const uint8_t* block, size_t len,
                                bool end_stream, IOBuf* batch_out) {
  std::string flat, path;
  if (!h->dec.decode(block, len, &flat, &path)) return false;
  {
    std::lock_guard g(h->h2_mu);
    if (h->streams.size() >= kMaxConcurrentStreams &&
        h->streams.find(sid) == h->streams.end()) {
      return false;  // connection error: stream table full
    }
    if (sid > h->max_client_sid) h->max_client_sid = sid;
    H2StreamN& st = h->streams[sid];
    if (st.headers_done) {
      // trailers on a request stream: append to the flat block, under
      // the same total header-bytes bound as any block (a trailer flood
      // on one stream must not grow memory unboundedly)
      if (st.flat_headers.size() + flat.size() > kMaxHeaderBlock) {
        return false;
      }
      st.flat_headers.append(flat);
    } else {
      st.flat_headers = std::move(flat);
      st.path = std::move(path);
      st.headers_done = true;
      st.send_window = h->peer_initial_window;
      st.recv_ns = nat_now_ns();
    }
    st.end_stream = end_stream;
  }
  if (end_stream) h2_dispatch(s, h, sid, batch_out);
  return true;
}

int h2_try_process(NatSocket* s, IOBuf* batch_out) {
  if (s->h2 == nullptr) {
    char pfx[24];
    size_t n = s->in_buf.length() < kPrefaceLen ? s->in_buf.length()
                                                : kPrefaceLen;
    s->in_buf.copy_to(pfx, n);
    int sn = h2_sniff(pfx, n);
    if (sn == 0) return 0;
    if (sn == 2) return 2;
    if (s->server == nullptr) return 0;  // server-side lane only
    s->in_buf.pop_front(kPrefaceLen);
    s->h2 = new H2SessionN();
    // our SETTINGS (empty = all defaults) opens the server side of the
    // connection preface
    std::string hello;
    frame_header(&hello, 0, kFSettings, 0, 0);
    batch_out->append(hello.data(), hello.size());
  }
  H2SessionN* h = s->h2;
  std::string out;  // control responses (acks, window updates)
  while (true) {
    if (s->in_buf.length() < 9) break;
    uint8_t fh[9];
    s->in_buf.copy_to((char*)fh, 9);
    size_t flen = NAT_WIRE(((size_t)fh[0] << 16) | ((size_t)fh[1] << 8) |
                           fh[2]);
    uint8_t ftype = fh[3];
    uint8_t flags = fh[4];
    uint32_t sid = (((uint32_t)fh[5] & 0x7f) << 24) |
                   ((uint32_t)fh[6] << 16) | ((uint32_t)fh[7] << 8) |
                   (uint32_t)fh[8];
    if (flen > (16u << 20)) return 0;  // far past any sane max frame
    if (s->in_buf.length() < 9 + flen) break;
    s->in_buf.pop_front(9);
    std::string payload;
    payload.resize(flen);
    if (flen > 0) s->in_buf.copy_to(&payload[0], flen);
    s->in_buf.pop_front(flen);
    const uint8_t* p = (const uint8_t*)payload.data();

    if (h->cont_active && ftype != kFContinuation) return 0;

    switch (ftype) {
      case kFSettings: {
        if (flags & kFlagAck) break;
        if (flen % 6 != 0) return 0;
        for (size_t i = 0; i + 6 <= flen; i += 6) {
          uint16_t id = ((uint16_t)p[i] << 8) | p[i + 1];
          uint32_t val = ((uint32_t)p[i + 2] << 24) |
                         ((uint32_t)p[i + 3] << 16) |
                         ((uint32_t)p[i + 4] << 8) | p[i + 5];
          if (id == 1) {  // HEADER_TABLE_SIZE: bounds OUR encoder table
            // Flush every already-assembled block in this round's
            // accumulators to the socket BEFORE arming the resize:
            // whoever carries the §4.2 update next (reading thread OR a
            // py-thread static block, which writes immediately under
            // h->h2_mu) must not overtake blocks encoded against the old
            // table — the update's eviction would turn their indexed
            // refs into ghosts on the decoder.
            if (!out.empty()) {
              batch_out->append(out.data(), out.size());
              out.clear();
            }
            if (!batch_out->empty()) s->write(std::move(*batch_out));
            std::lock_guard g(h->h2_mu);
            size_t cap = val > 4096 ? 4096 : (size_t)val;
            h->enc.target = cap;
            if (cap < h->enc.lowest) h->enc.lowest = cap;
            h->enc.pending_resize = (h->enc.target != h->enc.max_size ||
                                     h->enc.lowest < h->enc.max_size);
          } else if (id == 4) {  // INITIAL_WINDOW_SIZE
            std::lock_guard g(h->h2_mu);
            int64_t delta = (int64_t)val - h->peer_initial_window;
            h->peer_initial_window = val;
            for (auto& kv : h->streams) kv.second.send_window += delta;
          } else if (id == 5) {  // MAX_FRAME_SIZE
            if (val >= 16384 && val <= (1u << 24) - 1) {
              h->peer_max_frame = val;
            }
          }
        }
        frame_header(&out, 0, kFSettings, kFlagAck, 0);
        break;
      }
      case kFPing: {
        if (flags & kFlagAck) break;
        if (flen != 8) return 0;
        frame_header(&out, 8, kFPing, kFlagAck, 0);
        out.append(payload);
        break;
      }
      case kFWindowUpdate: {
        if (flen != 4) return 0;
        uint32_t inc = (((uint32_t)p[0] & 0x7f) << 24) |
                       ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) |
                       p[3];
        {
          std::lock_guard g(h->h2_mu);
          if (sid == 0) {
            h->conn_send_window += inc;
          } else {
            auto it = h->streams.find(sid);
            if (it != h->streams.end()) it->second.send_window += inc;
          }
        }
        h2_flush_pending(s, h, &out);
        break;
      }
      case kFPriority:
        break;  // advisory; ignored
      case kFRstStream: {
        std::lock_guard g(h->h2_mu);
        h->streams.erase(sid);
        break;
      }
      case kFGoaway:
        break;  // the peer will close; nothing to do
      case kFPushPromise:
        return 0;  // clients must not push
      case kFHeaders: {
        // request streams are client-initiated: odd, nonzero sid
        if (sid == 0 || (sid & 1) == 0) return 0;
        size_t off = 0;
        size_t end = flen;
        if (flags & kFlagPadded) {
          if (flen < 1) return 0;
          uint8_t pad = p[0];
          off = 1;
          if (pad > end - off) return 0;
          end -= pad;
        }
        if (flags & kFlagPriority) {
          if (end - off < 5) return 0;
          off += 5;
        }
        bool end_stream = (flags & kFlagEndStream) != 0;
        if (end - off > kMaxHeaderBlock) return 0;  // both branches
        if (flags & kFlagEndHeaders) {
          if (!h2_headers_complete(s, h, sid, p + off, end - off,
                                   end_stream, batch_out)) {
            return 0;
          }
        } else {
          h->cont_active = true;
          h->cont_sid = sid;
          h->cont_end_stream = end_stream;
          h->cont_block.assign((const char*)(p + off), end - off);
        }
        break;
      }
      case kFContinuation: {
        if (!h->cont_active || sid != h->cont_sid) return 0;
        if (h->cont_block.size() + payload.size() > kMaxHeaderBlock) {
          return 0;  // unbounded CONTINUATION accumulation
        }
        h->cont_block.append(payload);
        if (flags & kFlagEndHeaders) {
          h->cont_active = false;
          if (!h2_headers_complete(
                  s, h, sid, (const uint8_t*)h->cont_block.data(),
                  h->cont_block.size(), h->cont_end_stream, batch_out)) {
            return 0;
          }
          h->cont_block.clear();
        }
        break;
      }
      case kFData: {
        size_t off = 0;
        size_t end = flen;
        if (flags & kFlagPadded) {
          if (flen < 1) return 0;
          uint8_t pad = p[0];
          off = 1;
          if (pad > end - off) return 0;
          end -= pad;
        }
        bool end_stream = (flags & kFlagEndStream) != 0;
        // sid 0 / even sids are never legal for client DATA
        if (sid == 0 || (sid & 1) == 0) return 0;
        bool drop = false;
        {
          std::lock_guard g(h->h2_mu);
          // DATA must land on a stream HEADERS opened — never auto-create
          // a table entry (remote memory growth). An unknown sid is NOT a
          // connection error though: in-flight DATA racing our processing
          // of the client's own RST_STREAM is legal (RFC 9113 §5.1) and
          // must be ignored, not kill every other stream.
          auto dit = h->streams.find(sid);
          if (dit == h->streams.end() || !dit->second.headers_done ||
              dit->second.dispatched) {
            drop = true;  // post-RST / post-END_STREAM frames: ignore
          } else {
            H2StreamN& st = dit->second;
            st.data.append((const char*)(p + off), end - off);
            if (st.data.size() > (512u << 20)) return 0;
            st.end_stream = end_stream;
          }
        }
        if (drop) end_stream = false;  // dropped frames never dispatch
        // replenish recv windows so the client keeps sending (we buffer
        // whole messages, so consumption == receipt)
        if (flen > 0) {
          // connection window replenishes even for dropped frames (they
          // consumed it on the wire); the stream window only for live ones
          frame_header(&out, 4, kFWindowUpdate, 0, 0);
          uint32_t inc = (uint32_t)flen;
          out.push_back((char)((inc >> 24) & 0x7f));
          out.push_back((char)((inc >> 16) & 0xff));
          out.push_back((char)((inc >> 8) & 0xff));
          out.push_back((char)(inc & 0xff));
          if (!drop && !end_stream) {
            frame_header(&out, 4, kFWindowUpdate, 0, sid);
            out.push_back((char)((inc >> 24) & 0x7f));
            out.push_back((char)((inc >> 16) & 0xff));
            out.push_back((char)((inc >> 8) & 0xff));
            out.push_back((char)(inc & 0xff));
          }
        }
        if (end_stream) h2_dispatch(s, h, sid, batch_out);
        break;
      }
      default:
        break;  // unknown frame types are ignored (RFC 7540 §4.1)
    }
  }
  if (!out.empty()) batch_out->append(out.data(), out.size());
  return 1;
}

void h2_session_free(H2SessionN* h) { delete h; }

// Lame-duck GOAWAY (quiesce phase 2, RFC 7540 §6.8): NO_ERROR with
// last_stream_id = the highest client stream seen — "I will finish
// those; open new streams elsewhere". Clients with the PR-1 graceful-
// GOAWAY handling detach and re-dial while in-flight streams complete.
void h2_send_goaway(NatSocket* s) {
  H2SessionN* h = s->h2;
  if (h == nullptr) return;
  std::string out;
  {
    std::lock_guard g(h->h2_mu);
    if (h->sent_goaway) return;  // idempotent per session
    h->sent_goaway = true;
    static const char kDebug[] = "lame duck";
    frame_header(&out, 8 + sizeof(kDebug) - 1, kFGoaway, 0, 0);
    uint32_t last = h->max_client_sid;
    out.push_back((char)((last >> 24) & 0x7f));
    out.push_back((char)((last >> 16) & 0xff));
    out.push_back((char)((last >> 8) & 0xff));
    out.push_back((char)(last & 0xff));
    out.append(4, '\x00');  // NO_ERROR
    out.append(kDebug, sizeof(kDebug) - 1);
    // write under h2_mu: GOAWAY must not interleave a response frame
    IOBuf f;
    f.append(out.data(), out.size());
    s->write(std::move(f));
  }
}

// Streams not yet answered (or flow-parked bytes) on this session?
// (quiesce drain predicate)
bool h2_session_busy(NatSocket* s) {
  H2SessionN* h = s->h2;
  if (h == nullptr) return false;
  std::lock_guard g(h->h2_mu);
  return !h->streams.empty() || !h->pending.empty();
}

// Shared primitives for the client lane (nat_client.cpp): the frame
// emitter and a heap HpackDecoderN behind an opaque pointer so the
// decoder class (and its tables) stay private to this TU.
void h2_frame_header(std::string* out, size_t len, uint8_t type,
                     uint8_t flags, uint32_t sid) {
  frame_header(out, len, type, flags, sid);
}
void* hpack_decoder_new() { return new HpackDecoderN(); }
bool hpack_decoder_decode(void* dec, const uint8_t* d, size_t n,
                          std::string* flat, std::string* path) {
  return ((HpackDecoderN*)dec)->decode(d, n, flat, path);
}
void hpack_decoder_free(void* dec) { delete (HpackDecoderN*)dec; }

extern "C" {

// Python lane answer for a kind-4 request: unary gRPC response (payload
// framed + trailers with grpc-status). Ordering is per-stream, so
// concurrent py workers may respond in any order.
int nat_grpc_respond(uint64_t sock_id, int64_t sid, const char* payload,
                     size_t payload_len, int grpc_status,
                     const char* grpc_message) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  if (s->h2 == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return -1;
  }
  h2_respond(s, (uint32_t)sid, payload, payload_len, grpc_status,
             grpc_message, nullptr);
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
