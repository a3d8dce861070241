// Native HTTP/1.1 server-side lane — parse in the native cut loop, execute
// usercode in Python (kind-3 py-lane requests) or in registered native
// handlers, answer through the native Socket write queue with
// pipelining-order preservation.
//
// Reference shape: brpc parses HTTP natively beside the socket
// (details/http_parser.cpp, a vendored joyent parser) and dispatches via
// policy/http_rpc_protocol.cpp; builtin services run in C++
// (server.cpp:468-563). Here the parse is a from-scratch incremental
// header scanner over IOBuf, the usercode split is the py lane
// (usercode_backup_pool discipline), and response ordering across the
// native/py lanes is a per-session (seq -> response) reorder window —
// the pipelining discipline http_rpc_protocol.cpp keeps via its
// per-socket response queue.
#include "nat_internal.h"

namespace brpc_tpu {

static constexpr size_t kMaxHeaderBytes = 64u << 10;
static constexpr size_t kMaxBodyBytes = 512u << 20;

struct HttpSessionN {
  // written by the reading thread only (relaxed RMW); the quiesce drain
  // predicate and the lame-duck close read it from other threads, so it
  // is atomic — the value is advisory there (settled by double-polls)
  std::atomic<uint64_t> next_req_seq{1};
  // Response reorder window: responses (native or py) may complete out of
  // request order; only the response matching next_resp_seq is written,
  // later ones park. mu guards everything below (py pthreads + reading
  // thread both emit).
  NatMutex<kLockRankHttpSess> http_mu;
  uint64_t next_resp_seq = 1;
  // IOBuf (not std::string) so parked responses can carry arena-backed
  // user blocks (the shm drainer's zero-copy emit) without a copy
  struct Resp {
    IOBuf data;
    bool close = false;
  };
  std::map<uint64_t, Resp> parked;
  // requests that asked for Connection: close, by seq — the emitter
  // honors close even when the responder didn't echo it back
  std::vector<uint64_t> close_seqs;
  // Expect: 100-continue — the interim response was already sent for the
  // request currently awaiting its body (reading thread only)
  bool continue_sent = false;
  // Lame duck (server quiesce): every further response carries an
  // injected "Connection: close" header, and the connection closes once
  // the reorder window owes nothing — admitted pipelined requests all
  // get their responses before the FIN (under http_mu).
  bool lame_duck = false;
  // The reading thread is mid-round with possibly-unflushed responses
  // in its batch accumulator: py emissions must park instead of writing
  // directly, or a later seq could reach the write queue before the
  // accumulator's earlier ones (reordering on multi-core hosts).
  bool round_active = false;
};

int http_sniff(const char* p, size_t n) {
  static const char* kVerbs[] = {"GET ",     "POST ",  "PUT ",
                                 "DELETE ",  "HEAD ",  "OPTIONS ",
                                 "PATCH ",   "TRACE "};
  for (const char* v : kVerbs) {
    size_t vl = strlen(v);
    size_t cmp = n < vl ? n : vl;
    if (memcmp(p, v, cmp) == 0) return n >= vl ? 1 : 2;
  }
  return 0;
}

// Inject "Connection: close" right after the status line of a complete
// serialized response (lame-duck signaling). Zero-copy for the body:
// only the status line is rebuilt; the rest of the IOBuf moves over.
static void http_inject_conn_close(IOBuf* resp) {
  char head[256];
  size_t n = resp->length() < sizeof(head) ? resp->length() : sizeof(head);
  resp->copy_to(head, n);
  if (n < 12 || memcmp(head, "HTTP/", 5) != 0) return;  // not a head
  // don't double up an existing Connection header (responders that were
  // told close_after already wrote one). Anchored to line start and
  // bounded by the end of headers — a bare substring scan would match
  // "Proxy-Connection:" or body bytes and suppress the injection (the
  // client parser anchors the same way, nat_client.cpp).
  for (size_t i = 0; i + 12 < n; i++) {
    if (head[i] == '\r' && head[i + 1] == '\n' && head[i + 2] == '\r' &&
        head[i + 3] == '\n') {
      break;  // end of headers: the rest is body
    }
    if (head[i] == '\n' && (head[i + 1] == 'C' || head[i + 1] == 'c') &&
        memcmp(head + i + 2, "onnection:", 10) == 0) {
      return;
    }
  }
  const char* nl = (const char*)memchr(head, '\n', n);
  if (nl == nullptr) return;
  size_t line_end = (size_t)(nl - head) + 1;  // includes the \n
  IOBuf out;
  resp->cut_into(&out, line_end);
  out.append("Connection: close\r\n", 19);
  out.append(std::move(*resp));
  *resp = std::move(out);
}

// Write any now-in-order parked responses. Requires h->http_mu. Appends into
// out (the caller writes outside the lock).
static void http_emit_locked(NatSocket* s, HttpSessionN* h,
                             IOBuf* out, bool* want_close) {
  while (true) {
    auto it = h->parked.find(h->next_resp_seq);
    if (it == h->parked.end()) break;
    // parked-window accounting: pre-inject length matches the park-side
    // add (the lame-duck header injection grows only the wire bytes)
    s->conn_parked_sub(it->second.data.length());
    if (h->lame_duck) http_inject_conn_close(&it->second.data);
    out->append(std::move(it->second.data));
    bool close = it->second.close;
    if (!close) {
      for (uint64_t cs : h->close_seqs) {
        if (cs == h->next_resp_seq) {
          close = true;
          break;
        }
      }
    }
    h->parked.erase(it);
    h->next_resp_seq++;
    if (close) {
      *want_close = true;
      break;  // nothing after a close goes out
    }
  }
  // lame duck: once the window owes nothing (every admitted response
  // went out), the connection closes — FIN after the last byte. The
  // next_req_seq read races the reading thread by design; the close is
  // re-evaluated on every later emission, so a miss here only delays.
  if (h->lame_duck && h->parked.empty() &&
      h->next_resp_seq ==
          h->next_req_seq.load(std::memory_order_relaxed)) {
    *want_close = true;
  }
}

// Queue a complete response for `seq`, preserving request order. Called
// from the reading thread (native handlers) and from py pthreads.
static void http_emit_response(NatSocket* s, uint64_t seq, IOBuf data,
                               bool close, IOBuf* batch_out) {
  HttpSessionN* h = s->http;
  if (h == nullptr) return;
  nat_counter_add(NS_HTTP_RESPONSES_OUT, 1);
  s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  IOBuf out;
  bool want_close = false;
  bool wrote = false;
  {
    std::lock_guard g(h->http_mu);
    auto& slot = h->parked[seq];
    slot.data = std::move(data);
    slot.close = close;
    s->conn_parked_add(slot.data.length());
    if (batch_out == nullptr && h->round_active) {
      // the reading thread's round holds unflushed earlier responses;
      // stay parked — http_round_end drains after its flush
      return;
    }
    http_emit_locked(s, h, &out, &want_close);
    if (!out.empty()) {
      if (want_close) {
        s->close_after_drain.store(true, std::memory_order_release);
      }
      if (batch_out != nullptr) {
        // single-producer: batch_out is the reading thread's per-round
        // accumulator; only reading-thread emissions use it
        batch_out->append(std::move(out));
      } else {
        // the socket write happens UNDER h->http_mu: two py responders that
        // drain consecutive seqs must hit the write queue in that order
        // (emitting outside the lock let the later seq overtake)
        s->write(std::move(out));
        wrote = true;
      }
    } else if (want_close) {
      s->close_after_drain.store(true, std::memory_order_release);
    }
  }
  if (wrote && want_close) {
    // the write may have drained synchronously before the flag was
    // visible to it — re-arm with the Dekker-paired recheck
    s->arm_close_after_drain();
  }
}

static void build_http_response(std::string* out, int status,
                                const char* content_type,
                                const char* body, size_t body_len,
                                bool head_only) {
  const char* reason = status == 200   ? "OK"
                       : status == 400 ? "Bad Request"
                       : status == 404 ? "Not Found"
                       : status == 500 ? "Internal Server Error"
                                       : "Error";
  char hdr[256];
  int n = snprintf(hdr, sizeof(hdr),
                   "HTTP/1.1 %d %s\r\nServer: brpc_tpu_native\r\n"
                   "Content-Type: %s\r\nContent-Length: %zu\r\n\r\n",
                   status, reason, content_type, body_len);
  out->append(hdr, (size_t)n);
  if (!head_only && body_len) out->append(body, body_len);
}

// Interim 100 Continue for a body still in flight (curl waits for it).
// Only sent when every earlier pipelined response has already gone out —
// an interim reply jumping the reorder window would desynchronize the
// client's response matching.
static void http_maybe_send_continue(HttpSessionN* h, bool expect_continue,
                                     IOBuf* batch_out) {
  if (!expect_continue || h->continue_sent) return;
  {
    std::lock_guard g(h->http_mu);
    if (!h->parked.empty() || h->next_resp_seq !=
        h->next_req_seq.load(std::memory_order_relaxed)) {
      return;
    }
  }
  batch_out->append("HTTP/1.1 100 Continue\r\n\r\n", 25);
  h->continue_sent = true;
}

// Parse + dispatch every complete pipelined request buffered on s.
// Returns 1 (session active), 2 (sniff needs more bytes), 0 (error).
int http_try_process(NatSocket* s, IOBuf* batch_out) {
  if (s->http == nullptr) {
    char pfx[9] = {0};
    size_t n = s->in_buf.length() < 8 ? s->in_buf.length() : 8;
    s->in_buf.copy_to(pfx, n);
    int sn = http_sniff(pfx, n);
    if (sn == 0) return 0;
    if (sn == 2) return 2;
    if (s->server == nullptr) return 0;  // server-side lane only
    s->http = new HttpSessionN();
  }
  NatServer* srv = s->server;
  HttpSessionN* h = s->http;
  {
    std::lock_guard g(h->http_mu);
    h->round_active = true;
  }
  while (true) {
    size_t buffered = s->in_buf.length();
    if (buffered == 0) break;
    // locate end of headers without copying the whole buffer: scan a
    // bounded prefix (headers beyond 64KB are an error, as in the
    // Python parser)
    char stack_scan[4096];
    std::string heap_scan;
    size_t scan_len = buffered < kMaxHeaderBytes + 4 ? buffered
                                                     : kMaxHeaderBytes + 4;
    // natcheck:wire: scan — raw request bytes off the socket drain
    const char* scan;
    if (scan_len <= sizeof(stack_scan)) {
      scan = s->in_buf.fetch(stack_scan, scan_len);
    } else {
      heap_scan.resize(scan_len);
      s->in_buf.copy_to(&heap_scan[0], scan_len);
      scan = heap_scan.data();
    }
    const char* hdr_end = nullptr;
    for (size_t i = 0; i + 3 < scan_len; i++) {
      if (scan[i] == '\r' && scan[i + 1] == '\n' && scan[i + 2] == '\r' &&
          scan[i + 3] == '\n') {
        hdr_end = scan + i;
        break;
      }
    }
    if (hdr_end == nullptr) {
      if (buffered > kMaxHeaderBytes) return 0;  // oversized header
      break;                                     // need more bytes
    }
    size_t hdr_len = (size_t)(hdr_end - scan);
    uint64_t t_recv = nat_now_ns();  // request head fully buffered
    // request line: VERB SP URI SP VERSION
    const char* sp1 = (const char*)memchr(scan, ' ', hdr_len);
    if (sp1 == nullptr) return 0;
    const char* sp2 = (const char*)memchr(
        sp1 + 1, ' ', (size_t)(hdr_end - sp1 - 1));
    if (sp2 == nullptr) return 0;
    std::string_view verb(scan, (size_t)(sp1 - scan));
    std::string_view uri(sp1 + 1, (size_t)(sp2 - sp1 - 1));
    // header lines: lowercase keys in a flat "key: value\n" block for the
    // py lane; extract content-length / transfer-encoding / connection
    std::string flat;
    flat.reserve(hdr_len);
    size_t content_length = 0;
    bool chunked = false;
    bool conn_close = false;
    bool expect_continue = false;
    uint64_t trace_id = 0, parent_span = 0;  // x-bd-trace-* (hex)
    const char* line = (const char*)memchr(scan, '\n', hdr_len);
    line = line == nullptr ? hdr_end : line + 1;
    while (line < hdr_end) {
      const char* eol = (const char*)memchr(line, '\r',
                                            (size_t)(hdr_end - line));
      if (eol == nullptr) eol = hdr_end;
      const char* colon = (const char*)memchr(line, ':',
                                              (size_t)(eol - line));
      if (colon != nullptr) {
        size_t kstart = flat.size();
        for (const char* p = line; p < colon; p++) {
          flat.push_back((char)tolower((unsigned char)*p));
        }
        std::string_view key(flat.data() + kstart, flat.size() - kstart);
        const char* v = colon + 1;
        while (v < eol && (*v == ' ' || *v == '\t')) v++;
        const char* ve = eol;
        while (ve > v && (ve[-1] == ' ' || ve[-1] == '\t')) ve--;
        std::string_view val(v, (size_t)(ve - v));
        if (key == "content-length") {
          content_length = (size_t)NAT_WIRE(strtoull(
              std::string(val).c_str(), nullptr, 10));
        } else if (key == "transfer-encoding") {
          chunked = val.find("chunked") != std::string_view::npos;
        } else if (key == "connection") {
          // tolower for "Close"/"close"
          std::string lv(val);
          for (char& c : lv) c = (char)tolower((unsigned char)c);
          conn_close = lv.find("close") != std::string::npos;
        } else if (key == "expect") {
          expect_continue =
              val.find("100-continue") != std::string_view::npos;
        } else if (key == "x-bd-trace-id") {
          trace_id = strtoull(std::string(val).c_str(), nullptr, 16);
        } else if (key == "x-bd-span-id") {
          parent_span = strtoull(std::string(val).c_str(), nullptr, 16);
        }
        flat.push_back(':');
        flat.push_back(' ');
        flat.append(v, (size_t)(ve - v));
        flat.push_back('\n');
      }
      line = eol + 2;
    }
    if (content_length > kMaxBodyBytes) return 0;
    size_t body_start = hdr_len + 4;
    std::string body;
    size_t total = 0;
    if (chunked) {
      // dechunk (requires the full chunked body buffered — the Python
      // parser's discipline; chunked uploads are rare and small here)
      if (scan_len < buffered) {
        // the resize reallocates the buffer verb/uri point into: save
        // their offsets and rebind after the copy (use-after-free
        // otherwise, remotely reachable via a >64KB chunked upload)
        size_t verb_off = (size_t)(verb.data() - scan);
        size_t uri_off = (size_t)(uri.data() - scan);
        heap_scan.resize(buffered);
        s->in_buf.copy_to(&heap_scan[0], buffered);
        scan = heap_scan.data();
        scan_len = buffered;
        verb = std::string_view(scan + verb_off, verb.size());
        uri = std::string_view(scan + uri_off, uri.size());
      }
      size_t pos = body_start;
      bool done = false;
      while (true) {
        const char* nl = (const char*)memchr(scan + pos, '\n',
                                             scan_len - pos);
        if (nl == nullptr) break;
        size_t chunk_hdr_end = (size_t)(nl - scan) + 1;
        if (!isxdigit((unsigned char)scan[pos])) return 0;
        size_t sz = (size_t)NAT_WIRE(strtoull(scan + pos, nullptr, 16));
        // reject before arithmetic: sz near SIZE_MAX would wrap the
        // buffered-length comparison below and pass a bogus append
        if (sz > kMaxBodyBytes) return 0;
        if (sz == 0) {
          // trailer: expect final CRLF
          if (scan_len < chunk_hdr_end + 2) break;
          total = chunk_hdr_end + 2;
          done = true;
          break;
        }
        if (scan_len < chunk_hdr_end + sz + 2) break;
        body.append(scan + chunk_hdr_end, sz);
        if (body.size() > kMaxBodyBytes) return 0;
        pos = chunk_hdr_end + sz + 2;
      }
      if (!done) {
        // cap what an incomplete chunked body may buffer: without this a
        // peer that never sends the terminal chunk grows in_buf forever
        if (buffered > kMaxBodyBytes + 65536) return 0;
        http_maybe_send_continue(h, expect_continue, batch_out);
        break;  // need more bytes
      }
    } else {
      if (buffered < body_start + content_length) {
        http_maybe_send_continue(h, expect_continue, batch_out);
        break;  // need body
      }
      total = body_start + content_length;
    }
    // dispatch
    uint64_t t_parse = nat_now_ns();  // head + body parsed
    uint64_t seq =
        h->next_req_seq.fetch_add(1, std::memory_order_relaxed);
    h->continue_sent = false;  // this request is complete
    bool head_only = verb == "HEAD";
    std::string_view path = uri.substr(0, uri.find('?'));
    srv->requests.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_HTTP_MSGS_IN, 1);
    s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
    auto nit = srv->http_handlers.find(path);
    if (nit != srv->http_handlers.end()) {
      // native usercode, inline (builtin-service discipline): the
      // per-method row is keyed by the request path
      int midx = nat_method_idx(NL_HTTP, path.data(), path.size());
      nat_method_begin(midx);
      HttpHandlerCtxN ctx;
      ctx.verb = verb;
      ctx.path = path;
      if (chunked) {
        ctx.body = body;
      } else {
        // body view into the scan buffer (valid during the handler)
        if (scan_len >= body_start + content_length) {
          ctx.body = std::string_view(scan + body_start, content_length);
        } else {
          body.resize(content_length);
          s->in_buf.copy_to(&body[0], content_length, body_start);
          ctx.body = body;
        }
      }
      nit->second(ctx);
      uint64_t t_dispatch = nat_now_ns();
      std::string resp_bytes;
      std::string resp_body = ctx.resp_body.to_string();
      build_http_response(&resp_bytes, ctx.status, ctx.content_type,
                          resp_body.data(), resp_body.size(), head_only);
      if (conn_close) {
        std::lock_guard g(h->http_mu);
        h->close_seqs.push_back(seq);
      }
      // flight-recorder tap, also BEFORE pop_front (uri/body may view
      // into in_buf blocks the pop recycles): full URI + body + wire
      // trace context — replay re-fires it via nat_http_call
      if (nat_dump_enabled() && nat_dump_tick()) {
        nat_dump_sample(NL_HTTP, "", 0, uri.data(), uri.size(),
                        verb.data(), verb.size(), ctx.body.data(),
                        ctx.body.size(), trace_id, parent_span);
      }
      // capture the span method BEFORE pop_front: `path` may view into
      // in_buf's own blocks (fetch's zero-copy case) which the pop
      // recycles
      bool take_span = nat_span_tick();
      char span_path[48];
      size_t span_path_n = 0;
      if (take_span) {
        span_path_n = path.size() < sizeof(span_path) ? path.size()
                                                      : sizeof(span_path);
        memcpy(span_path, path.data(), span_path_n);
      }
      s->in_buf.pop_front(total);
      uint32_t req_bytes = (uint32_t)ctx.body.size();
      uint32_t out_bytes = (uint32_t)resp_bytes.size();
      IOBuf resp_buf;
      resp_buf.append(resp_bytes.data(), resp_bytes.size());
      http_emit_response(s, seq, std::move(resp_buf), false, batch_out);
      uint64_t t_write = nat_now_ns();
      nat_lat_record(NL_HTTP, t_write - t_parse);
      nat_method_end(midx, t_write - t_parse, ctx.status >= 400);
      if (take_span) {
        nat_span_record(NL_HTTP, s->id, span_path, span_path_n, t_recv,
                        t_parse, t_dispatch, t_write,
                        ctx.status >= 400 ? ctx.status : 0, req_bytes,
                        out_bytes, trace_id, parent_span);
      }
      if (s->failed.load(std::memory_order_acquire) ||
          s->close_after_drain.load(std::memory_order_acquire)) {
        break;
      }
      continue;
    }
    if (!srv->py_lane_enabled) {
      std::string resp_bytes;
      const char kBody[] = "no handler on native http port\n";
      build_http_response(&resp_bytes, 404, "text/plain", kBody,
                          sizeof(kBody) - 1, head_only);
      s->in_buf.pop_front(total);
      IOBuf resp_buf;
      resp_buf.append(resp_bytes.data(), resp_bytes.size());
      http_emit_response(s, seq, std::move(resp_buf), conn_close,
                         batch_out);
      continue;
    }
    // py lane: parse native, execute Python
    PyRequest* r = new PyRequest();
    r->kind = 3;
    r->sock_id = s->id;
    r->cid = (int64_t)seq;
    r->service.assign(verb.data(), verb.size());
    r->method.assign(uri.data(), uri.size());
    r->meta_bytes = std::move(flat);
    r->trace_id = trace_id;
    r->parent_span_id = parent_span;
    if (chunked) {
      r->payload = std::move(body);
    } else if (content_length > 0) {
      if (scan_len >= body_start + content_length) {
        r->payload.assign(scan + body_start, content_length);
      } else {
        r->payload.resize(content_length);
        s->in_buf.copy_to(&r->payload[0], content_length, body_start);
      }
    }
    if (conn_close) {
      std::lock_guard g(h->http_mu);
      h->close_seqs.push_back(seq);
    }
    // flight-recorder tap, py-lane arm (r->service = verb, r->method =
    // uri): the native-usercode seam above captures the other arm
    if (nat_dump_enabled() && nat_dump_tick()) {
      nat_dump_sample(NL_HTTP, "", 0, r->method.data(),
                      r->method.size(), r->service.data(),
                      r->service.size(), r->payload.data(),
                      r->payload.size(), trace_id, parent_span);
    }
    s->in_buf.pop_front(total);
    srv->enqueue_py(r);
  }
  return 1;
}

void http_session_free(HttpSessionN* h) { delete h; }

// Lame-duck this HTTP session (quiesce phase 2): every further response
// carries Connection: close; an idle session (nothing owed) closes
// right away — a keep-alive FIN on an idle connection is routine for
// any HTTP client.
void http_session_lame_duck(NatSocket* s) {
  HttpSessionN* h = s->http;
  if (h == nullptr) return;
  bool idle;
  {
    std::lock_guard g(h->http_mu);
    h->lame_duck = true;
    idle = h->parked.empty() &&
           h->next_resp_seq ==
               h->next_req_seq.load(std::memory_order_relaxed);
  }
  if (idle) s->arm_close_after_drain();
}

// Responses still owed on this session? (quiesce drain predicate; the
// next_req_seq read races the reading thread — the caller's settled
// double-poll absorbs it)
bool http_session_busy(NatSocket* s) {
  HttpSessionN* h = s->http;
  if (h == nullptr) return false;
  std::lock_guard g(h->http_mu);
  return !h->parked.empty() ||
         h->next_resp_seq != h->next_req_seq.load(std::memory_order_relaxed);
}

// End of a read round, called AFTER the round's batch accumulator was
// flushed to the write queue: drain responses py responders parked
// while the round was active, then let direct py writes through again.
void http_round_end(NatSocket* s) {
  HttpSessionN* h = s->http;
  if (h == nullptr) return;
  IOBuf out;
  bool want_close = false;
  std::lock_guard g(h->http_mu);
  http_emit_locked(s, h, &out, &want_close);
  h->round_active = false;
  if (want_close) s->close_after_drain.store(true, std::memory_order_release);
  if (!out.empty()) {
    s->write(std::move(out));  // under h->http_mu: ordered vs py emitters
  }
}

// Zero-copy emit for the shm drainer: `data` is the complete serialized
// response (possibly arena-backed user blocks); the reorder window parks
// the IOBuf itself, and the socket writev consumes the refs in place.
int http_respond_iobuf(uint64_t sock_id, int64_t seq, IOBuf&& data,
                       int close_after) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  if (s->http == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return -1;
  }
  http_emit_response(s, (uint64_t)seq, std::move(data), close_after != 0,
                     nullptr);
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

extern "C" {

// Python lane answer for a kind-3 request: `data` is the complete
// serialized HTTP response; close_after shuts the connection down once
// the bytes flush (Connection: close). Ordering across pipelined
// requests is enforced natively via the session reorder window.
int nat_http_respond(uint64_t sock_id, int64_t seq, const char* data,
                     size_t len, int close_after) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  if (s->http == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return -1;
  }
  IOBuf buf;
  buf.append(data, len);
  http_emit_response(s, (uint64_t)seq, std::move(buf), close_after != 0,
                     nullptr);
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

// Graceful close: fail the socket once queued writes drain (FIN after
// the last response byte) — Connection: close semantics for any lane.
int nat_sock_graceful_close(uint64_t sock_id) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  s->arm_close_after_drain();
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
