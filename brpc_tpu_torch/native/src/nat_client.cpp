// Native client lanes — HTTP/1.1 and h2/gRPC request framing + response
// parsing for channel-owned sockets, closing the client half of the
// native protocol asymmetry (the server half lives in nat_http.cpp /
// nat_h2.cpp).
//
// Reference shape: brpc's HTTP client packs requests in
// policy/http_rpc_protocol.cpp:663 (PackHttpRequest) and its h2 client
// keeps a per-connection H2Context with client-initiated streams
// (policy/http2_rpc_protocol.h:133 H2UnsentRequest, :285 PackH2Request).
// Here both lanes ride the SAME NatChannel pending-call table as tpu_std
// — correlation via FIFO order (HTTP/1.1 pipelining discipline) or the
// h2 stream id, completion via the versioned-slot CAS, deadlines via the
// native TimerThread, zero new correlation machinery.
#include <algorithm>

#include "nat_internal.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// HTTP/1.1 client session
// ---------------------------------------------------------------------------

static constexpr size_t kCliMaxHeaderBytes = 64u << 10;
static constexpr size_t kCliMaxBodyBytes = 512u << 20;

struct HttpCliSessN {
  // mu orders request writes with FIFO registration: cid push and the
  // socket write happen under one lock, so wire order == fifo order even
  // with concurrent callers (the pipelining correlation invariant).
  NatMutex<kLockRankHttpCli> httpc_mu;
  struct Req {
    int64_t cid;
    bool head;  // HEAD request: the response has headers but NO body
  };
  std::deque<Req> fifo;  // calls awaiting responses, request order
  // incremental response-parse state: phase 1 means the head response's
  // headers are consumed and `body_left` bytes of its content-length
  // body are still owed — body bytes are cut straight out of in_buf
  // into body_acc (refcounted blocks, no rescans). phase 2 is a
  // READ-UNTIL-CLOSE body (HTTP/1.0 or Connection: close with no
  // framing): everything until EOF is the body, and the call completes
  // from http_cli_on_socket_fail when the peer closes. Phases 0/1 are
  // reading-thread state; phase-2 mutations (and body_acc/status while
  // in it) happen under mu because the EOF hook may run on another
  // thread. The pending call is only claimed at COMPLETION, so the
  // deadline timer keeps working while a body trickles in.
  std::atomic<int> phase{0};  // 0 = headers, 1 = sized body, 2 = to-EOF
  int status = 0;
  size_t body_left = 0;
  IOBuf body_acc;
  // reading-thread only: a response WITHOUT Connection: close completed
  // on this connection (keep-alive established). The lame-duck signal
  // is the keep-alive -> close TRANSITION — a close-per-response server
  // (HTTP/1.0, keepalive off) closes from its first response and must
  // NOT be treated as draining, or it would permanently bypass the
  // breaker/retry-budget sampling.
  bool saw_keepalive = false;
};

static void http_cli_finish(PendingCall* pc);

// EOF on a client socket: a phase-2 (close-delimited) body is complete —
// claim the FIFO-head call and finish it with the accumulated bytes
// BEFORE fail_all turns it into an error. Called from set_failed.
void http_cli_on_socket_fail(NatSocket* s) {
  HttpCliSessN* c = s->httpc;
  if (c == nullptr) return;
  // cheap pre-check, then TRY-lock: set_failed can fire on a thread that
  // already holds c->httpc_mu (http_cli_send's write failing synchronously) —
  // blocking here would self-deadlock, and in that doomed-socket race
  // fail_all's error completion is the correct outcome anyway
  if (c->phase.load(std::memory_order_acquire) != 2) return;
  int status;
  IOBuf body;
  int64_t cid = 0;
  {
    std::unique_lock g(c->httpc_mu, std::try_to_lock);
    if (!g.owns_lock()) return;
    if (c->phase.load(std::memory_order_acquire) != 2) return;
    c->phase.store(0, std::memory_order_release);
    status = c->status;
    body = std::move(c->body_acc);
    if (c->fifo.empty()) return;
    cid = c->fifo.front().cid;
    c->fifo.pop_front();
  }
  // the close-delimited body IS a complete parsed response
  s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
  NatChannel* ch = s->channel;
  PendingCall* pc = ch != nullptr ? ch->take_pending(cid) : nullptr;
  if (pc == nullptr) return;
  pc->aux_status = status;
  pc->response.append(std::move(body));
  http_cli_finish(pc);
}

void http_cli_free(HttpCliSessN* c) { delete c; }

// Pop the FIFO head and claim its pending call (null when the response
// has no live waiter: timeout already fired, channel failed, or a
// response with no request). head_out reports whether the request was
// a HEAD (its response carries no body regardless of Content-Length).
static PendingCall* http_cli_take_head(NatSocket* s, bool* head_out) {
  HttpCliSessN* c = s->httpc;
  int64_t cid = 0;
  {
    std::lock_guard g(c->httpc_mu);
    if (c->fifo.empty()) {
      *head_out = false;
      return nullptr;
    }
    cid = c->fifo.front().cid;
    *head_out = c->fifo.front().head;
    c->fifo.pop_front();
  }
  NatChannel* ch = s->channel;
  return ch != nullptr ? ch->take_pending(cid) : nullptr;
}

static void http_cli_finish(PendingCall* pc) {
  // verdict for the HTTP client lane: transport errors and 5xx count
  // against the peer, only real successes replenish the retry budget
  // (the take_pending ok-arm defers to this layer, which knows status)
  if (pc->owner != nullptr) {
    bool call_ok = pc->error_code == 0 && pc->aux_status < 500;
    if (call_ok) pc->owner->note_call_success();
    if (pc->owner->breaker_enabled.load(std::memory_order_relaxed)) {
      pc->owner->breaker_on_call_end(call_ok);
    }
  }
  if (pc->cb != nullptr) {
    pc->cb(pc, pc->cb_arg);
  } else {
    pc->done.value.store(1, std::memory_order_release);
    Scheduler::butex_wake(&pc->done, INT32_MAX);
  }
}

int http_client_process(NatSocket* s) {
  HttpCliSessN* c = s->httpc;
  while (true) {
    // phase 2: close-delimited body — every byte until EOF belongs to
    // the head response (completion happens in http_cli_on_socket_fail)
    if (c->phase.load(std::memory_order_acquire) == 2) {
      std::lock_guard g(c->httpc_mu);
      if (s->in_buf.length() > 0) {
        s->in_buf.cut_into(&c->body_acc, s->in_buf.length());
      }
      return 1;
    }
    // phase 1: drain the current response's body straight out of in_buf
    // (no header rescans; block refs, not copies, for big bodies)
    if (c->phase.load(std::memory_order_acquire) == 1) {
      size_t take = s->in_buf.length() < c->body_left ? s->in_buf.length()
                                                      : c->body_left;
      if (take > 0) {
        s->in_buf.cut_into(&c->body_acc, take);
        c->body_left -= take;
      }
      if (c->body_left > 0) return 1;  // need more body bytes
      // a full response came off the wire whether or not a waiter is
      // still around (timeout may have reaped it): count the parse,
      // like the server-side c_in_msgs sites
      s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
      bool was_head = false;
      PendingCall* pc = http_cli_take_head(s, &was_head);
      if (pc != nullptr) {
        pc->aux_status = c->status;
        pc->response.append(std::move(c->body_acc));
        http_cli_finish(pc);
      }
      c->body_acc.clear();
      c->phase.store(0, std::memory_order_release);
    }
    size_t buffered = s->in_buf.length();
    if (buffered == 0) return 1;
    // headers fit in 64KB by contract: one bounded copy to scan them
    size_t scan_len =
        buffered < kCliMaxHeaderBytes ? buffered : kCliMaxHeaderBytes;
    std::string heap;
    heap.resize(scan_len);
    s->in_buf.copy_to(&heap[0], scan_len);
    const char* scan = heap.data();

    const char* hdr_end = nullptr;
    for (size_t i = 3; i < scan_len; i++) {
      if (scan[i - 3] == '\r' && scan[i - 2] == '\n' && scan[i - 1] == '\r' &&
          scan[i] == '\n') {
        hdr_end = scan + i - 3;
        break;
      }
    }
    if (hdr_end == nullptr) {
      return buffered >= kCliMaxHeaderBytes ? 0 : 1;  // need more bytes
    }
    size_t hdr_len = (size_t)(hdr_end - scan);
    // status line: HTTP/1.x NNN reason
    if (hdr_len < 12 || memcmp(scan, "HTTP/1.", 7) != 0) return 0;
    int status = atoi(scan + 9);
    if (status < 100 || status > 599) return 0;

    // headers we care about (lowercase the copy in place)
    std::string hdrs(scan, hdr_len);
    for (char& ch : hdrs) ch = (char)tolower((unsigned char)ch);
    // close-delimited detection (read-until-close bodies): HTTP/1.0
    // defaults to close unless keep-alive; 1.1 closes when asked to
    bool http10 = scan[7] == '0';
    bool conn_close = false, conn_keepalive = false;
    // anchored to line start: a bare substring would match
    // "proxy-connection:" (the status line always precedes, so a real
    // Connection header is always after a \n)
    size_t cpos = hdrs.find("\nconnection:");
    if (cpos != std::string::npos) {
      cpos += 1;
      size_t ceol = hdrs.find('\r', cpos);
      std::string cval = hdrs.substr(
          cpos + 11, (ceol == std::string::npos ? hdrs.size() : ceol) -
                         cpos - 11);
      conn_close = cval.find("close") != std::string::npos;
      conn_keepalive = cval.find("keep-alive") != std::string::npos;
    }
    bool close_delim_ok = conn_close || (http10 && !conn_keepalive);
    if (conn_close && s->channel != nullptr) {
      if (c->saw_keepalive) {
        // lame-duck signal: a previously keep-alive server now closes
        // after this response (the HTTP half of graceful quiesce).
        // Detach so NEW calls re-dial; the pipelined FIFO keeps
        // completing here, and the socket's eventual EOF is a planned
        // removal (no breaker penalty).
        channel_note_lame_duck(s->channel, s);
      } else {
        // close-per-response backend (HTTP/1.0 style): still detach —
        // new calls must not race the coming FIN — but keep the
        // channel OUT of the planned-churn window so the breaker and
        // retry budget keep sampling it normally.
        channel_detach_socket(s->channel, s);
      }
    } else if (!close_delim_ok && status / 100 != 1) {
      c->saw_keepalive = true;
    }
    size_t content_length = 0;
    bool has_cl = false, chunked = false;
    size_t clpos = hdrs.find("content-length:");
    if (clpos != std::string::npos) {
      content_length =
          (size_t)strtoull(hdrs.c_str() + clpos + 15, nullptr, 10);
      has_cl = true;
      if (content_length > kCliMaxBodyBytes) return 0;
    }
    if (hdrs.find("transfer-encoding:") != std::string::npos &&
        hdrs.find("chunked") != std::string::npos) {
      chunked = true;
    }
    size_t body_start = hdr_len + 4;

    if (status / 100 == 1) {  // 1xx interim (e.g. 100-continue): skip
      s->in_buf.pop_front(body_start);
      continue;
    }

    if (chunked) {
      // dechunk (full-body-buffered discipline, as the server lane);
      // chunked responses are small control payloads in practice
      if (scan_len < buffered) {
        heap.resize(buffered);
        s->in_buf.copy_to(&heap[0], buffered);
        scan = heap.data();
        scan_len = buffered;
      }
      std::string body;
      size_t pos = body_start;
      size_t total = 0;
      bool done = false;
      while (true) {
        const char* nl =
            (const char*)memchr(scan + pos, '\n', scan_len - pos);
        if (nl == nullptr) break;
        size_t chunk_hdr_end = (size_t)(nl - scan) + 1;
        if (!isxdigit((unsigned char)scan[pos])) return 0;
        size_t sz = (size_t)strtoull(scan + pos, nullptr, 16);
        if (sz > kCliMaxBodyBytes) return 0;
        if (sz == 0) {
          if (scan_len < chunk_hdr_end + 2) break;
          total = chunk_hdr_end + 2;
          done = true;
          break;
        }
        if (scan_len < chunk_hdr_end + sz + 2) break;
        body.append(scan + chunk_hdr_end, sz);
        if (body.size() > kCliMaxBodyBytes) return 0;
        pos = chunk_hdr_end + sz + 2;
      }
      if (!done) {
        return buffered > kCliMaxBodyBytes + 65536 ? 0 : 1;
      }
      s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
      bool was_head = false;
      PendingCall* pc = http_cli_take_head(s, &was_head);
      s->in_buf.pop_front(total);
      if (pc != nullptr) {
        pc->aux_status = status;
        if (body.size() <= sizeof(pc->inline_resp)) {
          memcpy(pc->inline_resp, body.data(), body.size());
          pc->inline_len = (uint8_t)body.size();
        } else {
          pc->response.append(body.data(), body.size());
        }
        http_cli_finish(pc);
      }
      continue;
    }

    // HEAD responses and 204/304 carry no body bytes regardless of any
    // Content-Length header (treating them as bodied would desync the
    // whole pipeline). Peek — the FIFO entry is only popped when the
    // response completes, so the deadline timer can still win.
    bool was_head = false;
    {
      std::lock_guard g(c->httpc_mu);
      if (!c->fifo.empty()) was_head = c->fifo.front().head;
    }
    bool head_like = was_head || status == 204 || status == 304;
    if (!head_like && !has_cl) {
      // no framing at all: legal ONLY when the server delimits the body
      // by closing (HTTP/1.0, or Connection: close) — accumulate until
      // EOF and complete from the socket-failure hook (ADVICE r5). A
      // keep-alive response with no framing is undecodable: fail the
      // socket explicitly instead of silently handing back empty bytes
      // (fail_all reports the error to the caller).
      if (!close_delim_ok) return 0;
      s->in_buf.pop_front(body_start);
      std::lock_guard g(c->httpc_mu);
      c->status = status;
      c->body_acc.clear();
      if (s->in_buf.length() > 0) {
        s->in_buf.cut_into(&c->body_acc, s->in_buf.length());
      }
      c->phase.store(2, std::memory_order_release);
      return 1;
    }
    size_t body_len = head_like ? 0 : content_length;
    s->in_buf.pop_front(body_start);
    if (body_len <= 4096 && s->in_buf.length() >= body_len) {
      // fast path: small fully-buffered body completes inline
      s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
      bool dummy = false;
      PendingCall* pc = http_cli_take_head(s, &dummy);
      if (pc == nullptr) {
        s->in_buf.pop_front(body_len);
        continue;
      }
      pc->aux_status = status;
      if (body_len <= sizeof(pc->inline_resp)) {
        s->in_buf.copy_to(pc->inline_resp, body_len);
        s->in_buf.pop_front(body_len);
        pc->inline_len = (uint8_t)body_len;
      } else {
        s->in_buf.cut_into(&pc->response, body_len);
      }
      http_cli_finish(pc);
    } else {
      // collect (large or not-yet-buffered) body incrementally
      c->phase.store(1, std::memory_order_release);
      c->status = status;
      c->body_left = body_len;
      c->body_acc.clear();
    }
  }
}

// ---------------------------------------------------------------------------
// h2/gRPC client session
// ---------------------------------------------------------------------------

// RFC 7540 constants (duplicated from nat_h2.cpp's private enum — they
// are protocol numbers, not shared state)
static const uint8_t kCFData = 0, kCFHeaders = 1, kCFRstStream = 3,
                     kCFSettings = 4, kCFPushPromise = 5, kCFPing = 6,
                     kCFGoaway = 7, kCFWindowUpdate = 8, kCFContinuation = 9;
static const uint8_t kCFlagEndStream = 0x1, kCFlagAck = 0x1,
                     kCFlagEndHeaders = 0x4, kCFlagPadded = 0x8,
                     kCFlagPriority = 0x20;
static const char kCPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
static const size_t kCMaxHeaderBlock = 1u << 20;

struct H2CliSessN {
  void* dec = nullptr;  // HpackDecoderN, reading thread only
  ~H2CliSessN() {
    if (dec != nullptr) hpack_decoder_free(dec);
  }
  // h2c_mu guards everything below AND orders stream writes on the socket
  // (sender threads and the reading-thread window flush both write
  // under it, so per-stream frame order is total).
  NatMutex<kLockRankH2Cli> h2c_mu;
  uint32_t next_sid = 1;
  int64_t conn_send_window = 65535;
  int64_t peer_initial_window = 65535;
  size_t peer_max_frame = 16384;
  // one-entry header-block cache: unary workloads hit the same :path
  // every call, so the HPACK encode (6 headers of string appends) runs
  // once, not per request (under mu)
  std::string cached_path;
  std::string cached_block;
  struct St {
    int64_t cid = 0;
    std::string flat;  // response headers + trailers, "name: value\n"
    std::string data;  // raw response DATA bytes (gRPC framed)
    std::string pend;  // unsent request DATA (flow-control parked)
    bool pend_end = false;  // END_STREAM still owed when pend drains
    bool headers_done = false;
    int64_t send_window = 65535;
  };
  std::map<uint32_t, St> streams;
  // graceful GOAWAY (RFC 7540 §6.8): streams <= goaway_last_sid are
  // still served by the peer; no NEW streams may open (under mu)
  bool goaway = false;
  uint32_t goaway_last_sid = 0;
  uint32_t sends_since_sweep = 0;  // dead-stream sweep cadence (under mu)
  // CONTINUATION accumulation (reading thread only)
  uint32_t cont_sid = 0;
  bool cont_active = false;
  bool cont_end_stream = false;
  std::string cont_block;
};

// Drop streams whose call is gone (deadline fired / channel failed) —
// without this, every timed-out call leaks an St and its parked request
// bytes forever, and the window flush keeps transmitting for the dead.
// Emits RST_STREAM for each so the server can free its half. Requires
// h->h2c_mu.
static void h2c_sweep_dead_locked(NatChannel* ch, H2CliSessN* h,
                                  std::string* out) {
  for (auto it = h->streams.begin(); it != h->streams.end();) {
    if (!ch->is_pending(it->second.cid)) {
      h2_frame_header(out, 4, kCFRstStream, 0, it->first);
      out->push_back('\x00');
      out->push_back('\x00');
      out->push_back('\x00');
      out->push_back('\x08');  // CANCEL
      it = h->streams.erase(it);
    } else {
      ++it;
    }
  }
}

void h2_cli_free(H2CliSessN* c) { delete c; }

// Frame as much of st->pend as the windows allow; requires h->h2c_mu.
// Emits the END_STREAM flag on the frame that drains pend.
static void h2c_pump_locked(H2CliSessN* h, H2CliSessN::St* st, uint32_t sid,
                            std::string* out) {
  while (!st->pend.empty() && h->conn_send_window > 0 &&
         st->send_window > 0) {
    size_t chunk = st->pend.size();
    if ((int64_t)chunk > h->conn_send_window) {
      chunk = (size_t)h->conn_send_window;
    }
    if ((int64_t)chunk > st->send_window) chunk = (size_t)st->send_window;
    if (chunk > h->peer_max_frame) chunk = h->peer_max_frame;
    bool last = chunk == st->pend.size();
    h2_frame_header(out, chunk, kCFData,
                    last && st->pend_end ? kCFlagEndStream : 0, sid);
    out->append(st->pend.data(), chunk);
    st->pend.erase(0, chunk);
    h->conn_send_window -= (int64_t)chunk;
    st->send_window -= (int64_t)chunk;
    if (last) st->pend_end = false;
  }
}

// Start a request stream: HEADERS + as much DATA as the windows allow,
// written under h->h2c_mu (wire order == sid order for the HEADERS).
// Returns 0 on success, else an error code.
static int h2c_send_request(NatChannel* ch, NatSocket* s,
                            const char* path, const char* payload,
                            size_t payload_len, int64_t cid,
                            const NatCallTrace* tr) {
  H2CliSessN* h = s->h2c;
  if (h == nullptr) return kEFAILEDSOCKET;
  // gRPC message framing: flag + 4B BE length + payload
  std::string data;
  data.reserve(5 + payload_len);
  data.push_back('\x00');
  data.push_back((char)((payload_len >> 24) & 0xff));
  data.push_back((char)((payload_len >> 16) & 0xff));
  data.push_back((char)((payload_len >> 8) & 0xff));
  data.push_back((char)(payload_len & 0xff));
  if (payload_len > 0) data.append(payload, payload_len);

  std::unique_lock g(h->h2c_mu);
  // stream-id space exhausted: fail the connection so the channel
  // re-dials fresh (the reference marks the connection unwritable too).
  // set_failed may sweep this session's streams (h2c_fail_own_streams
  // locks h->h2c_mu), so it must run AFTER the unlock.
  if (h->next_sid > 0x7ffffffd) {
    g.unlock();
    s->set_failed();
    return kEFAILEDSOCKET;
  }
  // draining after GOAWAY: the peer will not serve new streams. In-flight
  // streams <= last_stream_id keep completing; once none remain the
  // socket is failed so the channel re-dials.
  if (h->goaway) {
    bool drained = h->streams.empty();
    g.unlock();
    if (drained) s->set_failed();
    return kEFAILEDSOCKET;
  }
  if (++h->sends_since_sweep >= 512) {
    h->sends_since_sweep = 0;
    std::string rst;
    h2c_sweep_dead_locked(ch, h, &rst);
    if (!rst.empty()) {
      IOBuf rf;
      rf.append(rst.data(), rst.size());
      s->write(std::move(rf));
    }
  }
  if (h->cached_path != path) {
    h->cached_path = path;
    h->cached_block.clear();
    hp_enc_header(&h->cached_block, ":method", "POST");
    hp_enc_header(&h->cached_block, ":scheme", "http");
    hp_enc_header(&h->cached_block, ":path", path);
    hp_enc_header(&h->cached_block, ":authority", ch->authority);
    hp_enc_header(&h->cached_block, "content-type", "application/grpc");
    hp_enc_header(&h->cached_block, "te", "trailers");
  }
  const std::string* hdr_block = &h->cached_block;
  std::string traced_block;
  if (tr != nullptr && tr->trace_id != 0) {
    // trace metadata (static literal encoding: order-independent, no
    // dynamic-table state) — the server lane reads x-bd-trace-* back.
    // Untraced calls keep the zero-copy cached block.
    char tb[20], sb[20];
    snprintf(tb, sizeof(tb), "%llx", (unsigned long long)tr->trace_id);
    snprintf(sb, sizeof(sb), "%llx", (unsigned long long)tr->span_id);
    traced_block = h->cached_block;
    hp_enc_header(&traced_block, "x-bd-trace-id", tb);
    hp_enc_header(&traced_block, "x-bd-span-id", sb);
    hdr_block = &traced_block;
  }
  uint32_t sid = h->next_sid;
  h->next_sid += 2;
  H2CliSessN::St& st = h->streams[sid];
  st.cid = cid;
  st.send_window = h->peer_initial_window;
  st.pend = std::move(data);
  st.pend_end = true;
  std::string out;
  h2_frame_header(&out, hdr_block->size(), kCFHeaders, kCFlagEndHeaders,
                  sid);
  out.append(*hdr_block);
  h2c_pump_locked(h, &st, sid, &out);
  IOBuf f;
  f.append(out.data(), out.size());
  if (s->write(std::move(f)) != 0) {
    h->streams.erase(sid);
    return kEFAILEDSOCKET;
  }
  s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

static void h2c_complete_cids(NatChannel* ch,
                              const std::vector<int64_t>& cids,
                              int32_t code, const char* text);

void h2c_fail_own_streams(NatSocket* s, int32_t code, const char* text) {
  H2CliSessN* h = s->h2c;
  NatChannel* ch = s->channel;
  if (h == nullptr || ch == nullptr) return;
  std::vector<int64_t> cids;
  {
    std::lock_guard g(h->h2c_mu);
    for (auto& kv : h->streams) cids.push_back(kv.second.cid);
    h->streams.clear();
  }
  h2c_complete_cids(ch, cids, code, text);
}

// HTTP twin of h2c_fail_own_streams: a DETACHED (lame-duck) http client
// socket died — complete every call still waiting in its pipeline FIFO
// as a PLANNED error (retryable, no breaker sample), so a drained
// connection's stragglers never hang until their deadline. Called from
// set_failed's detached arm (fail_all only covers the attached socket).
void http_cli_fail_own(NatSocket* s, int32_t code, const char* text,
                       bool teardown) {
  HttpCliSessN* c = s->httpc;
  NatChannel* ch = s->channel;
  if (c == nullptr || ch == nullptr) return;
  std::vector<int64_t> cids;
  {
    // blocking on the fiber path (fresh fiber stack, same discipline as
    // h2c_fail_own_streams): a try-lock that loses to a sender mid-push
    // would strand every OTHER pipelined cid in the FIFO until its RPC
    // deadline — the exact hang this sweep exists to prevent. Teardown
    // (scheduler stopped) keeps the try-lock: backing off beats wedging
    // the exit path, and no fiber is left to contend anyway.
    std::unique_lock g(c->httpc_mu, std::defer_lock);
    if (teardown) {
      if (!g.try_lock()) return;
    } else {
      g.lock();
    }
    while (!c->fifo.empty()) {
      cids.push_back(c->fifo.front().cid);
      c->fifo.pop_front();
    }
  }
  for (int64_t cid : cids) {
    PendingCall* pc = ch->take_pending(cid, /*ok=*/false,
                                       /*planned=*/true);
    if (pc == nullptr) continue;
    pc->error_code = code;
    pc->error_text = text;
    if (pc->cb != nullptr) {
      pc->cb(pc, pc->cb_arg);
    } else {
      pc->done.value.store(1, std::memory_order_release);
      Scheduler::butex_wake(&pc->done, INT32_MAX);
    }
  }
}

// Teardown variant (set_failed with the scheduler stopped: no sweep
// fiber possible, and no running thread can hold h2c_mu). try_lock on
// purpose — it cannot deadlock, and if the lock is somehow contended
// during teardown, backing off beats wedging the exit path.
void h2c_fail_own_streams_teardown(NatSocket* s, int32_t code,
                                   const char* text) {
  H2CliSessN* h = s->h2c;
  NatChannel* ch = s->channel;
  if (h == nullptr || ch == nullptr) return;
  std::vector<int64_t> cids;
  {
    std::unique_lock g(h->h2c_mu, std::try_to_lock);
    if (!g.owns_lock()) return;
    for (auto& kv : h->streams) cids.push_back(kv.second.cid);
    h->streams.clear();
  }
  h2c_complete_cids(ch, cids, code, text);
}

static void h2c_complete_cids(NatChannel* ch,
                              const std::vector<int64_t>& cids,
                              int32_t code, const char* text) {
  for (int64_t cid : cids) {
    PendingCall* pc = ch->take_pending(cid, /*ok=*/false);
    if (pc == nullptr) continue;
    pc->error_code = code;
    pc->error_text = text;
    if (pc->cb != nullptr) {
      pc->cb(pc, pc->cb_arg);
    } else {
      pc->done.value.store(1, std::memory_order_release);
      Scheduler::butex_wake(&pc->done, INT32_MAX);
    }
  }
}

// END_STREAM arrived: extract (grpc-status, message, payload), complete.
static void h2c_complete(NatSocket* s, H2CliSessN* h, uint32_t sid) {
  int64_t cid;
  std::string flat, data;
  bool drained = false;
  {
    std::lock_guard g(h->h2c_mu);
    auto it = h->streams.find(sid);
    if (it == h->streams.end()) return;
    cid = it->second.cid;
    flat = std::move(it->second.flat);
    data = std::move(it->second.data);
    h->streams.erase(it);
    drained = h->goaway && h->streams.empty();
  }
  // /connections in_msg: one response parsed off this client socket
  // (the h2 server side counts at its own parse site, nat_h2.cpp)
  s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
  // last permitted stream after a graceful GOAWAY: retire the socket so
  // the channel re-dials instead of queueing calls a peer won't serve
  if (drained) s->set_failed();
  NatChannel* ch = s->channel;
  PendingCall* pc = ch != nullptr ? ch->take_pending(cid) : nullptr;
  if (pc == nullptr) return;
  // parse ":status", "grpc-status", "grpc-message" from the flat lines
  int http_status = 0, grpc_status = -1;
  std::string grpc_message;
  size_t pos = 0;
  while (pos < flat.size()) {
    size_t nl = flat.find('\n', pos);
    if (nl == std::string::npos) nl = flat.size();
    std::string_view line(flat.data() + pos, nl - pos);
    size_t co = line.find(": ");
    if (co != std::string_view::npos) {
      std::string_view name = line.substr(0, co);
      std::string_view val = line.substr(co + 2);
      if (name == ":status") {
        http_status = atoi(std::string(val).c_str());
      } else if (name == "grpc-status") {
        grpc_status = atoi(std::string(val).c_str());
      } else if (name == "grpc-message") {
        grpc_message = std::string(val);
      }
    }
    pos = nl + 1;
  }
  if (grpc_status < 0) {
    // no trailers: HTTP-level failure (or a non-gRPC peer)
    pc->error_code = kEFAILEDSOCKET;
    pc->error_text = "h2 response missing grpc-status";
    pc->aux_status = http_status;
  } else {
    pc->aux_status = grpc_status;
    pc->error_text = std::move(grpc_message);
    // de-frame the (single, uncompressed) response message
    if (data.size() >= 5 && data[0] == '\x00') {
      uint32_t mlen = rd_be32(data.data() + 1);
      if (5 + (size_t)mlen <= data.size()) {
        if (mlen <= sizeof(pc->inline_resp)) {
          memcpy(pc->inline_resp, data.data() + 5, mlen);
          pc->inline_len = (uint8_t)mlen;
        } else {
          pc->response.append(data.data() + 5, mlen);
        }
      }
    }
  }
  // verdict for the h2/gRPC client lane: transport failures and
  // server-stress statuses (RESOURCE_EXHAUSTED, UNAVAILABLE) count
  // against the peer; application-level statuses do not. Only real
  // successes replenish the retry budget.
  {
    bool call_ok = pc->error_code == 0 &&
                   pc->aux_status != 8 && pc->aux_status != 14;
    if (call_ok) ch->note_call_success();
    if (ch->breaker_enabled.load(std::memory_order_relaxed)) {
      ch->breaker_on_call_end(call_ok);
    }
  }
  if (pc->cb != nullptr) {
    pc->cb(pc, pc->cb_arg);
  } else {
    pc->done.value.store(1, std::memory_order_release);
    Scheduler::butex_wake(&pc->done, INT32_MAX);
  }
}

// Header block complete for sid (headers or trailers).
static bool h2c_headers_complete(NatSocket* s, H2CliSessN* h, uint32_t sid,
                                 const uint8_t* block, size_t len,
                                 bool end_stream) {
  std::string flat;
  if (!hpack_decoder_decode(h->dec, block, len, &flat, nullptr)) {
    return false;
  }
  {
    std::lock_guard g(h->h2c_mu);
    auto it = h->streams.find(sid);
    if (it == h->streams.end()) return true;  // stale (timed out): drop
    if (it->second.flat.size() + flat.size() > kCMaxHeaderBlock) {
      return false;
    }
    it->second.flat.append(flat);
    it->second.headers_done = true;
  }
  if (end_stream) h2c_complete(s, h, sid);
  return true;
}

// Window opened: pump every parked request stream that fits. Writes
// under h->h2c_mu (ordering with senders).
static void h2c_flush_parked(NatSocket* s, H2CliSessN* h) {
  NatChannel* ch = s->channel;
  std::string out;
  {
    std::lock_guard g(h->h2c_mu);
    for (auto it = h->streams.begin(); it != h->streams.end();) {
      if (!it->second.pend.empty()) {
        // a parked stream whose caller is gone must not burn window
        if (ch != nullptr && !ch->is_pending(it->second.cid)) {
          h2_frame_header(&out, 4, kCFRstStream, 0, it->first);
          out.append("\x00\x00\x00\x08", 4);  // CANCEL
          it = h->streams.erase(it);
          continue;
        }
        h2c_pump_locked(h, &it->second, it->first, &out);
        if (h->conn_send_window <= 0) break;
      }
      ++it;
    }
    if (!out.empty()) {
      IOBuf f;
      f.append(out.data(), out.size());
      s->write(std::move(f));
    }
  }
}

int h2_client_process(NatSocket* s, IOBuf* batch_out) {
  H2CliSessN* h = s->h2c;
  if (h == nullptr) return 0;
  std::string out;  // control frames (acks, window updates)
  while (true) {
    if (s->in_buf.length() < 9) break;
    uint8_t fh[9];
    s->in_buf.copy_to((char*)fh, 9);
    size_t flen = ((size_t)fh[0] << 16) | ((size_t)fh[1] << 8) | fh[2];
    uint8_t ftype = fh[3];
    uint8_t flags = fh[4];
    uint32_t sid = (((uint32_t)fh[5] & 0x7f) << 24) |
                   ((uint32_t)fh[6] << 16) | ((uint32_t)fh[7] << 8) |
                   (uint32_t)fh[8];
    if (flen > (16u << 20)) return 0;
    if (s->in_buf.length() < 9 + flen) break;
    s->in_buf.pop_front(9);
    std::string payload;
    payload.resize(flen);
    if (flen > 0) s->in_buf.copy_to(&payload[0], flen);
    s->in_buf.pop_front(flen);
    const uint8_t* p = (const uint8_t*)payload.data();

    if (h->cont_active && ftype != kCFContinuation) return 0;

    switch (ftype) {
      case kCFSettings: {
        if (flags & kCFlagAck) break;
        if (flen % 6 != 0) return 0;
        for (size_t i = 0; i + 6 <= flen; i += 6) {
          uint16_t id = ((uint16_t)p[i] << 8) | p[i + 1];
          uint32_t val = ((uint32_t)p[i + 2] << 24) |
                         ((uint32_t)p[i + 3] << 16) |
                         ((uint32_t)p[i + 4] << 8) | p[i + 5];
          if (id == 4) {
            std::lock_guard g(h->h2c_mu);
            int64_t delta = (int64_t)val - h->peer_initial_window;
            h->peer_initial_window = val;
            for (auto& kv : h->streams) kv.second.send_window += delta;
          } else if (id == 5) {
            if (val >= 16384 && val <= (1u << 24) - 1) {
              h->peer_max_frame = val;
            }
          }
        }
        h2_frame_header(&out, 0, kCFSettings, kCFlagAck, 0);
        // a raised initial window may unblock parked sends
        h2c_flush_parked(s, h);
        break;
      }
      case kCFPing: {
        if (flags & kCFlagAck) break;
        if (flen != 8) return 0;
        h2_frame_header(&out, 8, kCFPing, kCFlagAck, 0);
        out.append(payload);
        break;
      }
      case kCFWindowUpdate: {
        if (flen != 4) return 0;
        uint32_t inc = (((uint32_t)p[0] & 0x7f) << 24) |
                       ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) |
                       p[3];
        {
          std::lock_guard g(h->h2c_mu);
          if (sid == 0) {
            h->conn_send_window += inc;
          } else {
            auto it = h->streams.find(sid);
            if (it != h->streams.end()) it->second.send_window += inc;
          }
        }
        h2c_flush_parked(s, h);
        break;
      }
      case kCFRstStream: {
        if (flen != 4) return 0;
        int64_t cid = 0;
        {
          std::lock_guard g(h->h2c_mu);
          auto it = h->streams.find(sid);
          if (it == h->streams.end()) break;
          cid = it->second.cid;
          h->streams.erase(it);
        }
        NatChannel* ch = s->channel;
        PendingCall* pc =
            ch != nullptr ? ch->take_pending(cid, /*ok=*/false) : nullptr;
        if (pc != nullptr) {
          pc->error_code = kEFAILEDSOCKET;
          pc->error_text = "stream reset by server";
          if (pc->cb != nullptr) {
            pc->cb(pc, pc->cb_arg);
          } else {
            pc->done.value.store(1, std::memory_order_release);
            Scheduler::butex_wake(&pc->done, INT32_MAX);
          }
        }
        break;
      }
      case kCFGoaway: {
        // Graceful drain (ADVICE r5): streams <= last_stream_id will
        // still be served — keep them, fail only streams above it, and
        // stop opening new streams. A non-NO_ERROR GOAWAY still fails
        // the whole socket (fail_all completes pending calls).
        if (flen < 8) return 0;
        uint32_t last_sid = (((uint32_t)p[0] & 0x7f) << 24) |
                            ((uint32_t)p[1] << 16) |
                            ((uint32_t)p[2] << 8) | (uint32_t)p[3];
        uint32_t err_code = ((uint32_t)p[4] << 24) | ((uint32_t)p[5] << 16) |
                            ((uint32_t)p[6] << 8) | (uint32_t)p[7];
        if (err_code != 0) return 0;
        std::vector<int64_t> refused;
        bool drained;
        {
          std::lock_guard g(h->h2c_mu);
          // repeated GOAWAYs may only shrink the permitted window
          // (RFC 7540 §6.8: last_sid must not increase across frames)
          h->goaway_last_sid =
              h->goaway ? std::min(h->goaway_last_sid, last_sid) : last_sid;
          h->goaway = true;
          for (auto it = h->streams.begin(); it != h->streams.end();) {
            if (it->first > h->goaway_last_sid) {
              refused.push_back(it->second.cid);
              it = h->streams.erase(it);
            } else {
              ++it;
            }
          }
          drained = h->streams.empty();
        }
        NatChannel* ch = s->channel;
        // detach this socket from the channel NOW: new calls dial a
        // fresh connection immediately instead of hard-failing for the
        // whole drain window, while the permitted streams finish here.
        // A GOAWAY drain is PLANNED churn: the detach counts a
        // draining-redial and the refused-stream completions feed no
        // breaker sample (channel_note_lame_duck + planned=true below).
        if (ch != nullptr) channel_note_lame_duck(ch, s);
        for (int64_t cid : refused) {
          PendingCall* pc =
              ch != nullptr
                  ? ch->take_pending(cid, /*ok=*/false, /*planned=*/true)
                  : nullptr;
          if (pc == nullptr) continue;
          pc->error_code = kEFAILEDSOCKET;
          pc->error_text = "stream refused by GOAWAY";
          if (pc->cb != nullptr) {
            pc->cb(pc, pc->cb_arg);
          } else {
            pc->done.value.store(1, std::memory_order_release);
            Scheduler::butex_wake(&pc->done, INT32_MAX);
          }
        }
        if (drained) return 0;  // nothing left to serve: recycle now
        break;
      }
      case kCFPushPromise:
        return 0;  // we never enable push
      case kCFHeaders: {
        size_t off = 0, end = flen;
        if (flags & kCFlagPadded) {
          if (flen < 1) return 0;
          uint8_t pad = p[0];
          off = 1;
          if (pad > end - off) return 0;
          end -= pad;
        }
        if (flags & kCFlagPriority) {
          if (end - off < 5) return 0;
          off += 5;
        }
        if (end - off > kCMaxHeaderBlock) return 0;
        bool end_stream = (flags & kCFlagEndStream) != 0;
        if (flags & kCFlagEndHeaders) {
          if (!h2c_headers_complete(s, h, sid, p + off, end - off,
                                    end_stream)) {
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
      case kCFContinuation: {
        if (!h->cont_active || sid != h->cont_sid) return 0;
        if (h->cont_block.size() + payload.size() > kCMaxHeaderBlock) {
          return 0;
        }
        h->cont_block.append(payload);
        if (flags & kCFlagEndHeaders) {
          h->cont_active = false;
          if (!h2c_headers_complete(
                  s, h, sid, (const uint8_t*)h->cont_block.data(),
                  h->cont_block.size(), h->cont_end_stream)) {
            return 0;
          }
          h->cont_block.clear();
        }
        break;
      }
      case kCFData: {
        size_t off = 0, end = flen;
        if (flags & kCFlagPadded) {
          if (flen < 1) return 0;
          uint8_t pad = p[0];
          off = 1;
          if (pad > end - off) return 0;
          end -= pad;
        }
        bool end_stream = (flags & kCFlagEndStream) != 0;
        bool known = false;
        {
          std::lock_guard g(h->h2c_mu);
          auto it = h->streams.find(sid);
          if (it != h->streams.end()) {
            known = true;
            it->second.data.append((const char*)(p + off), end - off);
            if (it->second.data.size() > kCliMaxBodyBytes) return 0;
          }
        }
        // replenish our receive windows so big responses keep flowing
        if (flen > 0) {
          uint32_t inc = (uint32_t)flen;
          h2_frame_header(&out, 4, kCFWindowUpdate, 0, 0);
          out.push_back((char)((inc >> 24) & 0x7f));
          out.push_back((char)((inc >> 16) & 0xff));
          out.push_back((char)((inc >> 8) & 0xff));
          out.push_back((char)(inc & 0xff));
          if (known && !end_stream) {
            h2_frame_header(&out, 4, kCFWindowUpdate, 0, sid);
            out.push_back((char)((inc >> 24) & 0x7f));
            out.push_back((char)((inc >> 16) & 0xff));
            out.push_back((char)((inc >> 8) & 0xff));
            out.push_back((char)(inc & 0xff));
          }
        }
        if (known && end_stream) h2c_complete(s, h, sid);
        break;
      }
      default:
        break;  // unknown frames ignored (RFC 7540 §4.1)
    }
  }
  if (!out.empty()) batch_out->append(out.data(), out.size());
  return 1;
}

// ---------------------------------------------------------------------------
// Session attach + C API
// ---------------------------------------------------------------------------

void channel_attach_client_session(NatChannel* ch, NatSocket* s) {
  if (ch->protocol == 1) {
    s->httpc = new HttpCliSessN();
  } else if (ch->protocol == 2) {
    s->h2c = new H2CliSessN();
    s->h2c->dec = hpack_decoder_new();
    // client connection preface + our SETTINGS (defaults)
    std::string hello(kCPreface, 24);
    h2_frame_header(&hello, 0, kCFSettings, 0, 0);
    IOBuf f;
    f.append(hello.data(), hello.size());
    s->write(std::move(f));
  }
}

// Send an HTTP/1.1 request on the channel's socket, registering cid in
// the pipeline FIFO. extra_headers: raw "Name: value\r\n" lines or null.
static int http_cli_send(NatChannel* ch, NatSocket* s, const char* verb,
                         const char* path, const char* extra_headers,
                         const char* body, size_t body_len, int64_t cid,
                         const NatCallTrace* tr) {
  HttpCliSessN* c = s->httpc;
  if (c == nullptr) return kEFAILEDSOCKET;
  char head[576];
  int n = snprintf(head, sizeof(head),
                   "%s %s HTTP/1.1\r\nHost: %s\r\nContent-Length: %zu\r\n",
                   verb, path, ch->authority.c_str(), body_len);
  if (n < 0 || (size_t)n >= sizeof(head)) return kEFAILEDSOCKET;
  if (tr != nullptr && tr->trace_id != 0) {
    // trace headers (hex): the server lane's x-bd-trace-* parse chains
    // its span under this call's span in /rpcz find_trace
    int m = snprintf(head + n, sizeof(head) - (size_t)n,
                     "x-bd-trace-id: %llx\r\nx-bd-span-id: %llx\r\n",
                     (unsigned long long)tr->trace_id,
                     (unsigned long long)tr->span_id);
    if (m < 0 || (size_t)(n + m) >= sizeof(head)) return kEFAILEDSOCKET;
    n += m;
  }
  IOBuf f;
  f.append(head, (size_t)n);
  if (extra_headers != nullptr && extra_headers[0] != '\0') {
    f.append(extra_headers, strlen(extra_headers));
  }
  f.append("\r\n", 2);
  if (body_len > 0) f.append(body, body_len);
  std::lock_guard g(c->httpc_mu);
  c->fifo.push_back({cid, strcmp(verb, "HEAD") == 0});
  if (s->write(std::move(f)) != 0) {
    // the failed write swept pending calls via fail_all; drop the fifo
    // entry if it's still ours to drop
    if (!c->fifo.empty() && c->fifo.back().cid == cid) c->fifo.pop_back();
    return kEFAILEDSOCKET;
  }
  s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  return 0;
}

extern "C" {

// nat_channel_open_proto lives in nat_channel.cpp (channel_open_impl):
// the session must attach before the socket joins epoll.

struct Acall2Ctx {
  nat_acall2_cb cb;
  void* arg;
};

static void acall2_complete(PendingCall* pc, void* raw) {
  Acall2Ctx* ctx = (Acall2Ctx*)raw;
  if (pc->inline_len > 0) {
    ctx->cb(ctx->arg, pc->error_code, pc->aux_status, pc->inline_resp,
            pc->inline_len);
  } else {
    std::string resp = pc->response.to_string();
    ctx->cb(ctx->arg, pc->error_code, pc->aux_status, resp.data(),
            resp.size());
  }
  pc_free(pc);
  delete ctx;
}

// Shared sync harvest: park, then copy out (mirrors call_attempt).
static int harvest_sync(NatChannel* ch, PendingCall* pc, int* aux_out,
                        char** resp_out, size_t* resp_len,
                        char** err_text_out) {
  while (pc->done.value.load(std::memory_order_acquire) == 0) {
    Scheduler::butex_wait(&pc->done, 0);
  }
  int rc = pc->error_code;
  if (aux_out != nullptr) *aux_out = pc->aux_status;
  if (resp_out != nullptr) {
    if (rc == 0) {
      *resp_len =
          pc->inline_len > 0 ? pc->inline_len : pc->response.length();
      *resp_out = (char*)malloc(*resp_len ? *resp_len : 1);
      if (pc->inline_len > 0) {
        memcpy(*resp_out, pc->inline_resp, pc->inline_len);
      } else {
        pc->response.copy_to(*resp_out, *resp_len);
      }
    } else {
      *resp_out = nullptr;
      *resp_len = 0;
    }
  }
  if (err_text_out != nullptr) {
    if (!pc->error_text.empty()) {
      *err_text_out = (char*)malloc(pc->error_text.size() + 1);
      memcpy(*err_text_out, pc->error_text.c_str(),
             pc->error_text.size() + 1);
    } else {
      *err_text_out = nullptr;
    }
  }
  pc_free(pc);
  return rc;
}

// On send failure: complete/reap the call exactly once (fail_all may
// have consumed it already).
static void reap_failed_send(NatChannel* ch, PendingCall* pc, int64_t cid) {
  PendingCall* mine = ch->take_pending(cid, /*ok=*/false);
  if (mine != nullptr) {
    pc_free(mine);
    return;
  }
  while (pc->done.value.load(std::memory_order_acquire) == 0) {
    Scheduler::butex_wait(&pc->done, 0);
  }
  pc_free(pc);
}

int nat_http_call(void* h, const char* verb, const char* path,
                  const char* extra_headers, const char* body,
                  size_t body_len, int timeout_ms, int* status_out,
                  char** resp_out, size_t* resp_len) {
  NatChannel* ch = (NatChannel*)h;
  if (status_out != nullptr) *status_out = 0;
  NatSocket* s = channel_socket(ch, timeout_ms);
  if (s == nullptr) return kEFAILEDSOCKET;
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(verb, " ", path);
  int64_t cid = 0;
  PendingCall* pc = ch->begin_call(&cid, nullptr, nullptr, &tr);
  if (pc == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return kEFAILEDSOCKET;
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  int rc = http_cli_send(ch, s, verb, path, extra_headers, body, body_len,
                         cid, &tr);
  if (rc != 0) {
    reap_failed_send(ch, pc, cid);
    NAT_REF_RELEASE(s, sock.borrow);
    return rc;
  }
  NAT_REF_RELEASE(s, sock.borrow);
  return harvest_sync(ch, pc, status_out, resp_out, resp_len, nullptr);
}

int nat_http_acall(void* h, const char* verb, const char* path,
                   const char* extra_headers, const char* body,
                   size_t body_len, int timeout_ms, nat_acall2_cb cb,
                   void* arg) {
  NatChannel* ch = (NatChannel*)h;
  NatSocket* s = channel_socket(ch);
  if (s == nullptr) return kEFAILEDSOCKET;
  Acall2Ctx* ctx = new Acall2Ctx{cb, arg};
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(verb, " ", path);
  int64_t cid = 0;
  if (ch->begin_call(&cid, acall2_complete, ctx, &tr) == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    delete ctx;
    return kEFAILEDSOCKET;
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  int rc = http_cli_send(ch, s, verb, path, extra_headers, body, body_len,
                         cid, &tr);
  if (rc != 0) {
    // complete through the callback exactly once (unless fail_all
    // already swept the cid and fired it)
    PendingCall* mine = ch->take_pending(cid, /*ok=*/false);
    if (mine != nullptr) {
      mine->error_code = rc;
      mine->error_text = "socket failed before write";
      acall2_complete(mine, ctx);
    }
  }
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

int nat_grpc_call(void* h, const char* path, const char* payload,
                  size_t payload_len, int timeout_ms, int* grpc_status_out,
                  char** resp_out, size_t* resp_len, char** err_text_out) {
  NatChannel* ch = (NatChannel*)h;
  if (grpc_status_out != nullptr) *grpc_status_out = -1;
  NatSocket* s = channel_socket(ch, timeout_ms);
  if (s == nullptr) return kEFAILEDSOCKET;
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(path, "", "");
  int64_t cid = 0;
  PendingCall* pc = ch->begin_call(&cid, nullptr, nullptr, &tr);
  if (pc == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    return kEFAILEDSOCKET;
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  int rc = h2c_send_request(ch, s, path, payload, payload_len, cid, &tr);
  if (rc != 0) {
    reap_failed_send(ch, pc, cid);
    NAT_REF_RELEASE(s, sock.borrow);
    return rc;
  }
  NAT_REF_RELEASE(s, sock.borrow);
  return harvest_sync(ch, pc, grpc_status_out, resp_out, resp_len,
                      err_text_out);
}

int nat_grpc_acall(void* h, const char* path, const char* payload,
                   size_t payload_len, int timeout_ms, nat_acall2_cb cb,
                   void* arg) {
  NatChannel* ch = (NatChannel*)h;
  NatSocket* s = channel_socket(ch);
  if (s == nullptr) return kEFAILEDSOCKET;
  Acall2Ctx* ctx = new Acall2Ctx{cb, arg};
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(path, "", "");
  int64_t cid = 0;
  if (ch->begin_call(&cid, acall2_complete, ctx, &tr) == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    delete ctx;
    return kEFAILEDSOCKET;
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  int rc = h2c_send_request(ch, s, path, payload, payload_len, cid, &tr);
  if (rc != 0) {
    // complete through the callback exactly once (unless fail_all did)
    PendingCall* mine = ch->take_pending(cid, /*ok=*/false);
    if (mine != nullptr) {
      mine->error_code = rc;
      mine->error_text = "socket failed before write";
      acall2_complete(mine, ctx);
    }
  }
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
