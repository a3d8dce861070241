// Minimal protobuf varint codec for the tpu_std RpcMeta subset — enough to
// speak brpc_tpu/rpc/proto/rpc_meta.proto on the wire without a protobuf
// dependency (the native fast path of the tpu_std framing,
// baidu_rpc_protocol.cpp:95-137 role).
//
// Fields handled: RpcMeta{request{service_name=1, method_name=2},
// response{error_code=1, error_text=2}, compress_type=3, correlation_id=4,
// attachment_size=5}. Unknown fields are skipped on decode.
#pragma once

#include <cstdint>
#include <string>

// wire-origin marker for the wiretrust taint pass; canonical definition
// and grammar live in nat_internal.h (this header is also included
// standalone, so the guard is repeated)
#ifndef NAT_WIRE
#define NAT_WIRE(x) (x)
#endif

namespace brpc_tpu {

struct RpcRequestMetaN {
  std::string service_name;
  std::string method_name;
  // trace propagation (rpc_meta.proto RpcRequestMeta fields 4/5/6): the
  // caller's trace context, consumed by the server-side span records
  int64_t trace_id = 0;
  int64_t span_id = 0;
  int64_t parent_span_id = 0;
};

struct RpcResponseMetaN {
  int32_t error_code = 0;
  std::string error_text;
};

struct RpcMetaN {
  bool has_request = false;
  bool has_response = false;
  RpcRequestMetaN request;
  RpcResponseMetaN response;
  int32_t compress_type = 0;
  int64_t correlation_id = 0;
  int64_t attachment_size = 0;
  // Lame-duck wire signal (top-level RpcMeta field 8, our extension of
  // the tpu_std framing): a server entering graceful quiesce sets it on
  // a correlation_id=0 control frame (and on drain-window rejections) —
  // "finish what's in flight on this connection, send new work
  // elsewhere". Unknown to older peers, which skip the field.
  bool shutdown = false;
};

// ---- varint primitives ----

inline void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back((char)((v & 0x7F) | 0x80));
    v >>= 7;
  }
  out.push_back((char)v);
}

inline bool get_varint(const char*& p, const char* end, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = (uint8_t)*p++;
    r |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
    shift += 7;
  }
  return false;
}

inline void put_tag(std::string& out, int field, int wire) {
  put_varint(out, (uint64_t)(field << 3 | wire));
}

inline void put_str(std::string& out, int field, const std::string& s) {
  if (s.empty()) return;
  put_tag(out, field, 2);
  put_varint(out, s.size());
  out += s;
}

inline void put_int(std::string& out, int field, int64_t v) {
  if (v == 0) return;
  put_tag(out, field, 0);
  put_varint(out, (uint64_t)v);
}

// ---- RpcMeta encode ----

inline std::string encode_request_meta(const RpcMetaN& m) {
  std::string req;
  put_str(req, 1, m.request.service_name);
  put_str(req, 2, m.request.method_name);
  std::string out;
  put_tag(out, 1, 2);  // request submessage
  put_varint(out, req.size());
  out += req;
  put_int(out, 3, m.compress_type);
  put_int(out, 4, m.correlation_id);
  put_int(out, 5, m.attachment_size);
  return out;
}

inline std::string encode_response_meta(const RpcMetaN& m) {
  std::string resp;
  put_int(resp, 1, m.response.error_code);
  put_str(resp, 2, m.response.error_text);
  std::string out;
  if (!resp.empty()) {
    put_tag(out, 2, 2);  // response submessage
    put_varint(out, resp.size());
    out += resp;
  } else {
    // proto3 parsers need the field present to see HasField("response"):
    put_tag(out, 2, 2);
    put_varint(out, 0);
  }
  put_int(out, 3, m.compress_type);
  put_int(out, 4, m.correlation_id);
  put_int(out, 5, m.attachment_size);
  return out;
}

// ---- allocation-free encoders (hot path) ----
// The std::string encoders above stay for cold paths; the per-call path
// writes into a caller-provided stack buffer instead (one malloc per
// frame shows at M-qps rates). Callers size the buffer with the *_bound
// helpers; the functions return the encoded length.

inline char* raw_varint(char* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = (char)((v & 0x7F) | 0x80);
    v >>= 7;
  }
  *p++ = (char)v;
  return p;
}

inline size_t varint_len(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) {
    v >>= 7;
    n++;
  }
  return n;
}

inline size_t request_meta_bound(size_t slen, size_t mlen) {
  return slen + mlen + 72;  // fixed fields + the two 10-byte trace varints
}

inline size_t encode_request_meta_to(char* buf, const char* service,
                                     size_t slen, const char* method,
                                     size_t mlen, int64_t cid,
                                     int64_t att_size, uint64_t trace_id = 0,
                                     uint64_t span_id = 0) {
  char* p = buf;
  size_t sub = 0;
  if (slen) sub += 1 + varint_len(slen) + slen;
  if (mlen) sub += 1 + varint_len(mlen) + mlen;
  if (trace_id) sub += 1 + varint_len(trace_id);
  if (span_id) sub += 1 + varint_len(span_id);
  *p++ = (char)(1 << 3 | 2);  // request submessage
  p = raw_varint(p, sub);
  if (slen) {
    *p++ = (char)(1 << 3 | 2);
    p = raw_varint(p, slen);
    memcpy(p, service, slen);
    p += slen;
  }
  if (mlen) {
    *p++ = (char)(2 << 3 | 2);
    p = raw_varint(p, mlen);
    memcpy(p, method, mlen);
    p += mlen;
  }
  if (trace_id) {  // RpcRequestMeta.trace_id = 4
    *p++ = (char)(4 << 3 | 0);
    p = raw_varint(p, trace_id);
  }
  if (span_id) {  // RpcRequestMeta.span_id = 5 (the CALLER's span)
    *p++ = (char)(5 << 3 | 0);
    p = raw_varint(p, span_id);
  }
  if (cid != 0) {
    *p++ = (char)(4 << 3 | 0);
    p = raw_varint(p, (uint64_t)cid);
  }
  if (att_size != 0) {
    *p++ = (char)(5 << 3 | 0);
    p = raw_varint(p, (uint64_t)att_size);
  }
  return (size_t)(p - buf);
}

inline size_t response_meta_bound(size_t err_text_len) {
  return err_text_len + 48;
}

// `shutdown` != 0 appends the lame-duck bit (RpcMeta field 8) so a
// drain-window rejection doubles as the redial signal.
inline size_t encode_response_meta_to(char* buf, int32_t error_code,
                                      const char* err_text, size_t tlen,
                                      int64_t cid, int64_t att_size,
                                      int shutdown = 0) {
  char* p = buf;
  size_t sub = 0;
  if (error_code != 0) sub += 1 + varint_len((uint64_t)error_code);
  if (tlen) sub += 1 + varint_len(tlen) + tlen;
  // field always present so proto3 parsers see HasField("response")
  *p++ = (char)(2 << 3 | 2);
  p = raw_varint(p, sub);
  if (error_code != 0) {
    *p++ = (char)(1 << 3 | 0);
    p = raw_varint(p, (uint64_t)error_code);
  }
  if (tlen) {
    *p++ = (char)(2 << 3 | 2);
    p = raw_varint(p, tlen);
    memcpy(p, err_text, tlen);
    p += tlen;
  }
  if (cid != 0) {
    *p++ = (char)(4 << 3 | 0);
    p = raw_varint(p, (uint64_t)cid);
  }
  if (att_size != 0) {
    *p++ = (char)(5 << 3 | 0);
    p = raw_varint(p, (uint64_t)att_size);
  }
  if (shutdown != 0) {
    *p++ = (char)(8 << 3 | 0);
    *p++ = 1;
  }
  return (size_t)(p - buf);
}

// ---- RpcMeta decode ----

inline bool skip_field(const char*& p, const char* end, int wire) {
  uint64_t tmp;
  switch (wire) {
    case 0:
      return get_varint(p, end, &tmp);
    case 1:
      if (end - p < 8) return false;
      p += 8;
      return true;
    case 2: {
      if (!get_varint(p, end, &tmp) || (uint64_t)(end - p) < tmp) return false;
      p += tmp;
      return true;
    }
    case 5:
      if (end - p < 4) return false;
      p += 4;
      return true;
  }
  return false;
}

inline bool decode_submessage(const char* p, const char* end, RpcMetaN* m,
                              bool is_request) {
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    if (is_request && field == 1 && wire == 2) {
      uint64_t len;
      if (!get_varint(p, end, &len) || (uint64_t)(end - p) < len) return false;
      m->request.service_name.assign(p, len);
      p += len;
    } else if (is_request && field == 2 && wire == 2) {
      uint64_t len;
      if (!get_varint(p, end, &len) || (uint64_t)(end - p) < len) return false;
      m->request.method_name.assign(p, len);
      p += len;
    } else if (is_request && field >= 4 && field <= 6 && wire == 0) {
      uint64_t v;
      if (!get_varint(p, end, &v)) return false;
      if (field == 4) m->request.trace_id = (int64_t)v;
      else if (field == 5) m->request.span_id = (int64_t)v;
      else m->request.parent_span_id = (int64_t)v;
    } else if (!is_request && field == 1 && wire == 0) {
      uint64_t v;
      if (!get_varint(p, end, &v)) return false;
      m->response.error_code = (int32_t)v;
    } else if (!is_request && field == 2 && wire == 2) {
      uint64_t len;
      if (!get_varint(p, end, &len) || (uint64_t)(end - p) < len) return false;
      m->response.error_text.assign(p, len);
      p += len;
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  return true;
}

inline bool decode_meta(const char* data, size_t size, RpcMetaN* m) {
  // meta bytes come straight off the tpu_std frame cut: hostile
  const char* p = NAT_WIRE(data);
  const char* end = data + size;
  // natcheck:allow(wiretrust): cursor advances every iteration (every
  // arm either consumes bytes or returns false) and is capped by end
  while (p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) return false;
    int field = (int)(tag >> 3), wire = (int)(tag & 7);
    switch (field) {
      case 1: {  // request
        uint64_t len;
        if (wire != 2 || !get_varint(p, end, &len) ||
            (uint64_t)(end - p) < len)
          return false;
        m->has_request = true;
        if (!decode_submessage(p, p + len, m, true)) return false;
        p += len;
        break;
      }
      case 2: {  // response
        uint64_t len;
        if (wire != 2 || !get_varint(p, end, &len) ||
            (uint64_t)(end - p) < len)
          return false;
        m->has_response = true;
        if (!decode_submessage(p, p + len, m, false)) return false;
        p += len;
        break;
      }
      case 3: {
        uint64_t v;
        if (!get_varint(p, end, &v)) return false;
        m->compress_type = (int32_t)v;
        break;
      }
      case 4: {
        uint64_t v;
        if (!get_varint(p, end, &v)) return false;
        m->correlation_id = (int64_t)v;
        break;
      }
      case 5: {
        uint64_t v;
        if (!get_varint(p, end, &v)) return false;
        m->attachment_size = (int64_t)v;
        break;
      }
      case 8: {  // shutdown (lame-duck) bit
        uint64_t v;
        if (wire != 0 || !get_varint(p, end, &v)) return false;
        m->shutdown = v != 0;
        break;
      }
      default:
        if (!skip_field(p, end, wire)) return false;
    }
  }
  return true;
}

}  // namespace brpc_tpu
