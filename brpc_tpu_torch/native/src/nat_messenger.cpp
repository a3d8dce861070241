// Messenger — the tpu_std cut loop + dispatch (InputMessenger role,
// input_messenger.cpp:331): drain an fd / ring completion into the
// socket's native IOBuf, cut frames, process requests inline in the
// reading thread (native handlers / py-lane handoff), route responses to
// the owning channel's pending-call table. Also the frame builders and
// the native console HTTP answering GETs from native counters.
#include "nat_internal.h"

namespace brpc_tpu {

// Header + meta are encoded into ONE stack buffer and appended in a single
// call (one memcpy into the TLS share block, zero allocations); oversized
// error texts spill to a heap scratch, never truncate.
static void build_response_frame_ex(IOBuf* out, int64_t cid,
                                    int32_t error_code,
                                    const std::string& error_text,
                                    IOBuf&& payload, IOBuf&& attachment,
                                    int shutdown) {
  size_t bound = 12 + response_meta_bound(error_text.size());
  char stack_buf[320];
  // natcheck:allow(resacct): per-frame scratch, freed before return
  char* buf = bound <= sizeof(stack_buf) ? stack_buf : (char*)malloc(bound);
  size_t mlen = encode_response_meta_to(buf + 12, error_code,
                                        error_text.data(), error_text.size(),
                                        cid, (int64_t)attachment.length(),
                                        shutdown);
  memcpy(buf, kMagicRpc, 4);
  wr_be32(buf + 4,
          (uint32_t)(mlen + payload.length() + attachment.length()));
  wr_be32(buf + 8, (uint32_t)mlen);
  out->append(buf, 12 + mlen);
  if (buf != stack_buf) free(buf);
  out->append(std::move(payload));
  out->append(std::move(attachment));
}

void build_response_frame(IOBuf* out, int64_t cid, int32_t error_code,
                          const std::string& error_text, IOBuf&& payload,
                          IOBuf&& attachment) {
  nat_counter_add(NS_TPU_STD_RESPONSES_OUT, 1);
  build_response_frame_ex(out, cid, error_code, error_text,
                          std::move(payload), std::move(attachment), 0);
}

// Drain-window rejection frame: an ELIMIT-class error carrying the
// SHUTDOWN bit — the rejected client learns "redial elsewhere" even if
// it missed the correlation_id-0 lame-duck frame.
void build_reject_draining_frame(IOBuf* out, int64_t cid,
                                 int32_t error_code, const char* text) {
  nat_counter_add(NS_TPU_STD_RESPONSES_OUT, 1);
  build_response_frame_ex(out, cid, error_code, text, IOBuf(), IOBuf(),
                          /*shutdown=*/1);
}

// Meta-only lame-duck control frame (correlation_id 0, SHUTDOWN bit):
// "finish in-flight on this connection, send new work elsewhere".
void build_shutdown_frame(IOBuf* out) {
  build_response_frame_ex(out, 0, 0, std::string(), IOBuf(), IOBuf(),
                          /*shutdown=*/1);
}

void build_request_frame(IOBuf* out, int64_t cid, const std::string& service,
                         const std::string& method, const char* payload,
                         size_t payload_len, const char* att, size_t att_len,
                         uint64_t trace_id, uint64_t span_id) {
  size_t bound = 12 + request_meta_bound(service.size(), method.size());
  char stack_buf[320];
  // natcheck:allow(resacct): per-frame scratch, freed before return
  char* buf = bound <= sizeof(stack_buf) ? stack_buf : (char*)malloc(bound);
  size_t mlen = encode_request_meta_to(buf + 12, service.data(),
                                       service.size(), method.data(),
                                       method.size(), cid, (int64_t)att_len,
                                       trace_id, span_id);
  memcpy(buf, kMagicRpc, 4);
  wr_be32(buf + 4, (uint32_t)(mlen + payload_len + att_len));
  wr_be32(buf + 8, (uint32_t)mlen);
  out->append(buf, 12 + mlen);
  if (buf != stack_buf) free(buf);
  if (payload_len) out->append(payload, payload_len);
  if (att_len) out->append(att, att_len);
}

// Zero-copy variant for bulk senders: the attachment's refs SPLICE into
// the frame (user blocks over caller-owned memory ride straight into
// writev — the send half of the registered-arena discipline; the bulk
// bench and device-lane senders use it so a 1MB payload never pays a
// build memcpy).
void build_request_frame_iobuf(IOBuf* out, int64_t cid,
                               const std::string& service,
                               const std::string& method,
                               IOBuf&& attachment, uint64_t trace_id,
                               uint64_t span_id) {
  size_t att_len = attachment.length();
  size_t bound = 12 + request_meta_bound(service.size(), method.size());
  char stack_buf[320];
  // natcheck:allow(resacct): per-frame scratch, freed before return
  char* buf = bound <= sizeof(stack_buf) ? stack_buf : (char*)malloc(bound);
  size_t mlen = encode_request_meta_to(buf + 12, service.data(),
                                       service.size(), method.data(),
                                       method.size(), cid, (int64_t)att_len,
                                       trace_id, span_id);
  memcpy(buf, kMagicRpc, 4);
  wr_be32(buf + 4, (uint32_t)(mlen + att_len));
  wr_be32(buf + 8, (uint32_t)mlen);
  out->append(buf, 12 + mlen);
  if (buf != stack_buf) free(buf);
  out->append(std::move(attachment));
}

// Minimal HTTP console on the native port (the multi-protocol-port
// discipline of server.cpp: one port tries every protocol): GET
// /health /status /vars /version answer from native counters so the
// native runtime is self-observable without the Python lane.
// Returns 1 = handled a request, 2 = need more bytes, 0 = not HTTP.
static int try_process_http(NatSocket* s, IOBuf* batch_out) {
  char head[8] = {0};
  size_t n = s->in_buf.length() < 8 ? s->in_buf.length() : 8;
  s->in_buf.copy_to(head, n);
  bool is_head = memcmp(head, "HEAD", 4) == 0;
  if (memcmp(head, "GET ", 4) != 0 && !is_head) {
    return 0;
  }
  if (s->server == nullptr) return 0;
  std::string raw;
  raw.resize(s->in_buf.length());
  s->in_buf.copy_to(&raw[0], raw.size());
  size_t end = raw.find("\r\n\r\n");
  if (end == std::string::npos) {
    return raw.size() > (64u << 10) ? 0 : 2;  // oversized header: bail
  }
  std::string headers = raw.substr(0, end);  // THIS request only, not any
  for (char& c : headers) c = (char)tolower((unsigned char)c);
  // a body (Content-Length) must be consumed too, or its bytes would be
  // parsed as the next frame and poison the stream
  size_t body_len = 0;
  size_t clpos = headers.find("content-length:");
  if (clpos != std::string::npos) {
    body_len = (size_t)strtoul(headers.c_str() + clpos + 15, nullptr, 10);
    if (body_len > (64u << 10)) return 0;  // absurd for a console GET
  }
  if (raw.size() < end + 4 + body_len) return 2;  // body not buffered yet
  s->in_buf.pop_front(end + 4 + body_len);
  size_t p0 = raw.find(' ');
  size_t p1 = raw.find(' ', p0 + 1);
  std::string path = (p0 != std::string::npos && p1 != std::string::npos)
                         ? raw.substr(p0 + 1, p1 - p0 - 1)
                         : "/";
  bool keep_alive = headers.find("connection: close") == std::string::npos;
  std::string body;
  int status = 200;
  if (path == "/health") {
    body = "OK\n";
  } else if (path == "/version") {
    body = "brpc_tpu_native/1\n";
  } else if (path == "/status" || path == "/vars") {
    char buf[512];
    uint64_t ring_recv = 0, ring_send = 0;
    if (g_rings_ready.load(std::memory_order_acquire)) {
      for (RingListener* r : g_rings) {
        ring_recv += r->recv_completions();
        ring_send += r->send_completions();
      }
    }
    snprintf(buf, sizeof(buf),
             "nat_server_requests : %llu\n"
             "nat_server_connections : %llu\n"
             "nat_scheduler_workers : %d\n"
             "nat_scheduler_switches : %llu\n"
             "nat_ring_recv_completions : %llu\n"
             "nat_ring_send_completions : %llu\n",
             (unsigned long long)s->server->requests.load(std::memory_order_relaxed),
             (unsigned long long)s->server->connections.load(std::memory_order_relaxed),
             Scheduler::instance()->nworkers(),
             (unsigned long long)Scheduler::instance()->total_switches(),
             (unsigned long long)ring_recv,
             (unsigned long long)ring_send);
    body = buf;
  } else {
    status = 404;
    body = "no such page on the native port (try /status /vars /health)\n";
  }
  char hdr[256];
  snprintf(hdr, sizeof(hdr),
           "HTTP/1.1 %d %s\r\nServer: brpc_tpu_native\r\n"
           "Content-Type: text/plain\r\nContent-Length: %zu\r\n"
           "Connection: %s\r\n\r\n",
           status, status == 200 ? "OK" : "Not Found", body.size(),
           keep_alive ? "keep-alive" : "close");
  batch_out->append(hdr, strlen(hdr));
  if (!is_head) batch_out->append(body.data(), body.size());
  // Even for Connection: close we answer and let the PEER close (EOF
  // then fails the socket) — closing ourselves would race the
  // asynchronous write lanes (KeepWrite fiber / io_uring send) and could
  // drop the response bytes still queued.
  return 1;
}

// Parse the 9-byte stream frame header (8B dest stream id + 1B type)
// into a kind-5 request — shared by the buffered and fill paths.
static PyRequest* make_stream_request(NatSocket* s, const char fh[9]) {
  // natcheck:allow(resacct): PyRequest self-accounts in its ctor
  PyRequest* r = new PyRequest();
  r->kind = 5;
  r->sock_id = s->id;
  r->aux = ((uint64_t)rd_be32(fh) << 32) | rd_be32(fh + 4);
  r->compress_type = (int32_t)(uint8_t)fh[8];
  r->cid = (int64_t)(++s->stream_seq);
  return r;
}

// Grow the fill buffer so [0, need_off) is addressable: doubles toward
// big_len (realloc is mremap-cheap for large buffers). False on OOM.
static bool stream_fill_reserve(PyRequest* r, size_t need_off) {
  if (need_off <= r->big_cap) return true;
  size_t cap = r->big_cap > 0 ? r->big_cap : (1u << 20);
  while (cap < need_off) cap *= 2;
  if (cap > r->big_len) cap = r->big_len;
  // ledger: retire the old capacity BEFORE realloc can hand its pages
  // to a concurrent accounted allocation (the site profiler applies
  // events in global-ticket order — a FREE published after another
  // thread's ALLOC at the same address would erase that entry);
  // re-added on failure so the ledger stays balanced
  if (r->big_cap > 0) {
    NAT_RES_FREE(NR_SRV_PYREQ, r->big_cap, r->big_payload);
  }
  char* p = (char*)realloc(r->big_payload, cap);
  if (p == nullptr) {
    if (r->big_cap > 0) {
      NAT_RES_ALLOC(NR_SRV_PYREQ, r->big_cap, r->big_payload);
    }
    return false;
  }
  NAT_RES_ALLOC(NR_SRV_PYREQ, cap, p);
  r->big_payload = p;
  r->big_cap = cap;
  return true;
}

// Stream fill mode: feed `n` freshly-received bytes at `data` into the
// pending large-payload request. Returns the number of bytes consumed
// (the rest belongs to the next frame and goes to in_buf); SIZE_MAX on
// allocation failure. Enqueues the request when complete. Reading
// thread only.
size_t stream_fill_feed(NatSocket* s, const char* data, size_t n) {
  PyRequest* r = s->fill_req;
  size_t want = r->big_len - s->fill_off;
  size_t take = n < want ? n : want;
  if (!stream_fill_reserve(r, s->fill_off + take)) return SIZE_MAX;
  memcpy(r->big_payload + s->fill_off, data, take);
  s->fill_off += take;
  if (s->fill_off == r->big_len) {
    s->fill_req = nullptr;
    s->fill_off = 0;
    s->server->enqueue_py(r);
  }
  return take;
}

// tpu_std bulk-frame fill (read-side arena blocks, ISSUE 15): once the
// slab is full it joins in_buf as ONE user block — header + body are
// then contiguous refs and the normal cut loop slices meta/payload/
// attachment zero-copy out of the slab.
static void bulk_fill_complete(NatSocket* s) {
  char* p = s->bulk_buf;
  size_t cap = s->bulk_cap;
  size_t len = s->bulk_len;
  s->bulk_buf = nullptr;
  s->bulk_cap = s->bulk_len = s->bulk_off = 0;
  s->in_buf.append_user(p, len, iob_bulk_user_free, iob_bulk_ctx(p, cap));
  nat_counter_add(NS_BULK_FILL_FRAMES, 1);
}

size_t bulk_fill_feed(NatSocket* s, const char* data, size_t n) {
  size_t want = s->bulk_len - s->bulk_off;
  size_t take = n < want ? n : want;
  memcpy(s->bulk_buf + s->bulk_off, data, take);
  s->bulk_off += take;
  if (s->bulk_off == s->bulk_len) bulk_fill_complete(s);
  return take;
}

void bulk_fill_abort(NatSocket* s) {
  if (s->bulk_buf != nullptr) {
    iob_bulk_release(s->bulk_buf, s->bulk_cap);
    s->bulk_buf = nullptr;
    s->bulk_cap = s->bulk_len = s->bulk_off = 0;
  }
}

// Forward everything buffered on a raw-mode socket to the py lane as one
// ordered chunk.
static void forward_raw_chunk(NatSocket* s) {
  if (s->in_buf.empty()) return;
  // natcheck:allow(resacct): PyRequest self-accounts in its ctor
  PyRequest* r = new PyRequest();
  r->kind = 1;
  r->sock_id = s->id;
  r->cid = (int64_t)(++s->py_raw_seq);
  r->payload = s->in_buf.to_string();
  s->in_buf.clear();
  s->server->enqueue_py(r);
}

// Cut + process every complete frame in s->in_buf. Server requests run
// inline (responses batched into ONE socket write per read burst); client
// responses complete pending calls.
// With defer_out != nullptr, response bytes are parked there instead of
// being written per read burst — the epoll dispatcher passes its per-round
// accumulator so one writev covers EVERY burst of the round (cross-burst
// syscall batching; the client-side defer_writes twin of this discipline).
bool process_input(NatSocket* s, IOBuf* defer_out) {
  // TLS sniff (Socket-level SSLState, socket.h:539-540): on a
  // TLS-enabled server port the FIRST bytes decide — a handshake record
  // (0x16 0x03) builds the native SSL session and everything buffered so
  // far is ciphertext to feed it; anything else stays plaintext for
  // good. After the session exists, the read paths feed ciphertext
  // directly, so in_buf only ever holds plaintext here.
  if (s->server != nullptr && s->server->ssl_ctx != nullptr &&
      s->ssl_sess == nullptr && !s->ssl_declined) {
    if (s->in_buf.empty()) return true;
    char pfx[3] = {0};
    size_t pn = s->in_buf.length() < 3 ? s->in_buf.length() : 3;
    s->in_buf.copy_to(pfx, pn);
    if ((uint8_t)pfx[0] == 0x16) {
      if (pn < 3) return true;  // wait for the record version bytes
      if ((uint8_t)pfx[1] == 0x03) {
        if (!ssl_accept_begin(s)) return false;
        IOBuf cipher;
        cipher.append(std::move(s->in_buf));
        char tmp[16384];
        while (!cipher.empty()) {
          size_t n = cipher.length() < sizeof(tmp) ? cipher.length()
                                                   : sizeof(tmp);
          cipher.copy_to(tmp, n);
          cipher.pop_front(n);
          if (!ssl_feed(s, tmp, n)) return false;
        }
      } else {
        s->ssl_declined = true;
      }
    } else {
      s->ssl_declined = true;
    }
  }
  if (s->py_raw.load(std::memory_order_relaxed)) {
    forward_raw_chunk(s);
    return true;
  }
  IOBuf batch_out;
  bool ok = true;
  // client-side protocol lanes: a channel that speaks HTTP/h2 routes all
  // input to its client session (nat_client.cpp), never the tpu_std cut
  if (s->channel != nullptr && s->server == nullptr &&
      s->channel->protocol != 0) {
    int prc = s->channel->protocol == 2 ? h2_client_process(s, &batch_out)
                                        : http_client_process(s);
    if (prc == 0) ok = false;
    goto flush;
  }
  // native protocol sessions take over the whole connection once sniffed
  if (s->http != nullptr || s->h2 != nullptr || s->redis != nullptr) {
    int prc = s->h2 != nullptr      ? h2_try_process(s, &batch_out)
              : s->http != nullptr ? http_try_process(s, &batch_out)
                                   : redis_try_process(s, &batch_out);
    if (prc == 0) ok = false;
    goto flush;
  }
  while (true) {
    if (s->in_buf.length() < 12) {
      // Short first message (e.g. inline redis "PING\r\n"): if the bytes
      // already rule out the tpu_std magic, hand off to raw mode now
      // rather than deadlocking on a 12-byte header that never comes.
      if (!s->in_buf.empty() && s->server != nullptr &&
          s->server->py_lane_enabled) {
        char pfx[12];
        size_t n = s->in_buf.length() < 12 ? s->in_buf.length() : 12;
        s->in_buf.copy_to(pfx, n);
        if (s->server->native_http &&
            (http_sniff(pfx, n) != 0 || h2_sniff(pfx, n) != 0)) {
          break;  // could be a native-lane protocol: wait for 12+ bytes
        }
        if (s->server->native_redis != 0 && redis_sniff(pfx, n) != 0 &&
            s->server->py_lane_enabled) {
          // a COMPLETE command can be under 12 bytes ("*1\r\n$1\r\nX\r\n"
          // is 11): dispatch now — the lane handles partial input itself
          int prc = redis_try_process(s, &batch_out);
          if (prc == 1) break;
          ok = false;  // latched then erred
          break;
        }
        size_t sn = n < 4 ? n : 4;
        if (memcmp(pfx, "TSTR", sn) == 0) break;  // partial stream frame
        size_t mn = n < 4 ? n : 4;
        if (s->server->raw_fallback && memcmp(pfx, kMagicRpc, mn) != 0) {
          s->py_raw.store(true, std::memory_order_release);
          forward_raw_chunk(s);
        }
      }
      break;
    }
    char header[12];
    s->in_buf.copy_to(header, 12);
    if (memcmp(header, "TSTR", 4) == 0 && s->server != nullptr &&
        s->server->py_lane_enabled) {
      // Streaming frame (streaming_rpc_protocol.cpp role): cut natively,
      // deliver ordered to the Python Stream objects via the py lane —
      // the Python loop never re-parses stream framing. Body = 8B dest
      // stream id + 1B frame type + payload.
      uint32_t body = NAT_WIRE(rd_be32(header + 4));
      if (body < 9 || body > (512u << 20)) {
        ok = false;  // same body cap as every other native lane
        break;
      }
      if (s->in_buf.length() < 8 + (size_t)body) {
        // Large payload not fully buffered: switch to FILL MODE — the
        // remaining payload bytes go straight from the socket into the
        // request buffer, skipping in_buf and its extra copy (the
        // streaming_echo 1-64MB zero-copy north star). TLS stays on
        // the buffered path (payload bytes exist only post-decrypt).
        if ((size_t)body >= kStreamFillMin && s->ssl_sess == nullptr &&
            s->in_buf.length() >= 8 + 9) {
          s->in_buf.pop_front(8);
          char fh[9];
          s->in_buf.copy_to(fh, 9);
          s->in_buf.pop_front(9);
          PyRequest* r = make_stream_request(s, fh);
          // malloc'd, grown with received bytes (stream_fill_reserve) —
          // no zero-fill pass, and a header claiming a huge body can't
          // reserve the allocation up front
          r->big_len = (size_t)body - 9;
          size_t have = s->in_buf.length();  // all of it is payload
          if (!stream_fill_reserve(r, have)) {
            delete r;
            ok = false;
            break;
          }
          if (have > 0) {
            s->in_buf.copy_to(r->big_payload, have);
            s->in_buf.pop_front(have);
          }
          s->py_streams.store(true, std::memory_order_release);
          s->fill_req = r;
          s->fill_off = have;
        }
        break;
      }
      s->in_buf.pop_front(8);
      char fh[9];
      s->in_buf.copy_to(fh, 9);
      s->in_buf.pop_front(9);
      PyRequest* r = make_stream_request(s, fh);
      size_t plen = body - 9;
      if (plen > 0) {
        r->payload.resize(plen);
        s->in_buf.copy_to(&r->payload[0], plen);
        s->in_buf.pop_front(plen);
      }
      s->py_streams.store(true, std::memory_order_release);
      s->server->enqueue_py(r);
      continue;
    }
    if (memcmp(header, kMagicRpc, 4) != 0) {
      // Not tpu_std. Native HTTP/h2 sessions (sniff once, remember) take
      // precedence when enabled; then the raw-fallback py lane; then the
      // native console; else protocol error.
      if (s->server != nullptr && s->server->native_http &&
          s->server->py_lane_enabled) {
        int prc = h2_try_process(s, &batch_out);
        if (prc == 1 || prc == 2) break;  // h2 session latched (or needs
                                          // more preface bytes)
        if (s->h2 != nullptr) {
          // latched THEN erred (bad first frame after the preface): a
          // protocol error, not "not h2" — falling through would feed the
          // half-consumed stream to the HTTP/raw lanes
          ok = false;
          break;
        }
        prc = http_try_process(s, &batch_out);
        if (prc == 1 || prc == 2) break;  // http session latched
        // fall through: not HTTP-shaped either
      }
      if (s->server != nullptr && s->server->native_redis != 0 &&
          s->server->py_lane_enabled) {
        int prc = redis_try_process(s, &batch_out);
        if (prc == 1) break;  // redis session latched
        if (s->redis != nullptr) {
          ok = false;  // latched then erred
          break;
        }
      }
      if (s->server != nullptr && s->server->raw_fallback &&
          s->server->py_lane_enabled) {
        s->py_raw.store(true, std::memory_order_release);
        forward_raw_chunk(s);
        break;
      }
      int hrc = try_process_http(s, &batch_out);
      if (hrc == 1) continue;   // handled; keep cutting
      if (hrc == 2) break;      // incomplete request: wait for bytes
      ok = false;  // not tpu_std, not HTTP: protocol error
      break;
    }
    uint32_t body = NAT_WIRE(rd_be32(header + 4));
    uint32_t meta_size = NAT_WIRE(rd_be32(header + 8));
    if (meta_size > body || body > (512u << 20)) {
      ok = false;
      break;
    }
    if (s->in_buf.length() < 12 + (size_t)body) {
      // Bulk-frame fill: a large body's remaining bytes read straight
      // into ONE pooled slab (socket -> arena, no per-8KB block churn)
      // that joins in_buf as a single user block on completion — the
      // whole frame is then contiguous and meta/payload/attachment cut
      // zero-copy. TLS stays buffered (payload exists only post-decrypt).
      // Everything after the 12-byte header already buffered belongs to
      // THIS frame's body (length < 12 + body), so it moves into the
      // slab and in_buf shrinks to exactly the header.
      if ((size_t)body >= kBulkFillMin && s->ssl_sess == nullptr &&
          s->bulk_buf == nullptr && s->fill_req == nullptr) {
        size_t cap = 0;
        char* p = iob_bulk_acquire(body, &cap);
        if (p != nullptr) {
          size_t have = s->in_buf.length() - 12;
          if (have > 0) s->in_buf.copy_to(p, have, 12);
          s->in_buf.clear();
          s->in_buf.append(header, 12);
          s->bulk_buf = p;
          s->bulk_cap = cap;
          s->bulk_len = body;
          s->bulk_off = have;
        }
      }
      break;
    }
    uint64_t t_recv = nat_now_ns();  // frame fully buffered
    s->in_buf.pop_front(12);
    // decode straight from the buffer (fetch: contiguous view or stack
    // copy; meta blobs are tens of bytes — no heap string per frame)
    char meta_stack[512];
    const char* meta_ptr;
    std::string meta_heap;
    if (meta_size <= sizeof(meta_stack)) {
      meta_ptr = s->in_buf.fetch(meta_stack, meta_size);
    } else {
      meta_heap.resize(meta_size);
      s->in_buf.copy_to(&meta_heap[0], meta_size);
      meta_ptr = meta_heap.data();
    }
    RpcMetaN meta;
    if (!decode_meta(meta_ptr, meta_size, &meta)) {
      ok = false;
      break;
    }
    size_t att_size = (size_t)meta.attachment_size;
    if (att_size > body - meta_size) {
      ok = false;
      break;
    }
    // handler lookup BEFORE the meta pop: the py lane needs a copy of the
    // raw meta bytes, but only requests that actually go to the py lane
    // should pay it — native-handled frames stay allocation-free
    NatServer* srv =
        (meta.has_request && s->server != nullptr) ? s->server : nullptr;
    const NativeHandler* handler = nullptr;
    std::string meta_copy;
    if (srv != nullptr) {
      char keybuf[256];
      const std::string& sn = meta.request.service_name;
      const std::string& mn = meta.request.method_name;
      if (sn.size() + mn.size() + 1 <= sizeof(keybuf)) {
        memcpy(keybuf, sn.data(), sn.size());
        keybuf[sn.size()] = '.';
        memcpy(keybuf + sn.size() + 1, mn.data(), mn.size());
        handler = srv->find_handler(
            std::string_view(keybuf, sn.size() + 1 + mn.size()));
      }
      if (handler == nullptr && srv->py_lane_enabled) {
        meta_copy.assign(meta_ptr, meta_size);  // py lane re-parses it
      }
    }
    s->in_buf.pop_front(meta_size);
    size_t payload_size = body - meta_size - att_size;
    s->c_in_msgs.fetch_add(1, std::memory_order_relaxed);
    if (srv == nullptr && s->channel != nullptr) {
      // lame-duck signal (SHUTDOWN meta bit): the peer is draining —
      // detach this socket from the channel so new calls re-dial, keep
      // in-flight completing here, and charge NOTHING to the breaker
      // or the retry budget (planned churn is routine, not failure)
      if (meta.shutdown) {
        channel_note_lame_duck(s->channel, s);
        if (meta.correlation_id == 0) {  // pure control frame: no call
          s->in_buf.pop_front(payload_size + att_size);
          continue;
        }
      }
      // client response: route FIRST, then land the bytes — a small
      // payload goes straight into the call slot's inline buffer (no
      // IOBuf, no block refs), and a stale/duplicate response costs
      // only a pop_front
      PendingCall* pc = s->channel->take_pending(meta.correlation_id);
      if (pc == nullptr) {
        s->in_buf.pop_front(payload_size + att_size);
        continue;
      }
      pc->error_code = meta.has_response ? meta.response.error_code : 0;
      pc->error_text = meta.has_response ? meta.response.error_text : "";
      if (att_size == 0 && payload_size <= sizeof(pc->inline_resp)) {
        s->in_buf.copy_to(pc->inline_resp, payload_size);
        s->in_buf.pop_front(payload_size);
        pc->inline_len = (uint8_t)payload_size;
      } else {
        s->in_buf.cut_into(&pc->response, payload_size);
        s->in_buf.cut_into(&pc->attachment, att_size);
      }
      // tpu_std verdict: error frames (incl. ELIMIT shed) count against
      // the peer for the breaker and do not replenish the retry budget.
      // Drain-window rejections (shutdown bit) are PLANNED: no breaker
      // sample either way.
      {
        bool call_ok = pc->error_code == 0;
        if (call_ok) s->channel->note_call_success();
        if (!meta.shutdown &&
            s->channel->breaker_enabled.load(std::memory_order_relaxed)) {
          s->channel->breaker_on_call_end(call_ok);
        }
      }
      if (pc->cb != nullptr) {
        pc->cb(pc, pc->cb_arg);  // async completion; cb owns pc
      } else {
        pc->done.value.store(1, std::memory_order_release);
        Scheduler::butex_wake(&pc->done, INT32_MAX);
      }
      continue;
    }
    IOBuf payload, attachment;
    s->in_buf.cut_into(&payload, payload_size);
    s->in_buf.cut_into(&attachment, att_size);

    if (srv != nullptr) {
      srv->requests.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_TPU_STD_MSGS_IN, 1);
      if (nat_dump_enabled() && nat_dump_tick()) {
        // flight-recorder tap (nat_dump.h): the request payload with
        // the wire's trace context, BEFORE the handler/py-lane branch
        // so both dispatch paths are captured (attachment bytes stay
        // out — replay re-sends the payload field only)
        nat_dump_sample_iobuf(NL_ECHO, meta.request.service_name.data(),
                              meta.request.service_name.size(),
                              meta.request.method_name.data(),
                              meta.request.method_name.size(), payload,
                              (uint64_t)meta.request.trace_id,
                              (uint64_t)meta.request.span_id);
      }
      // this connection speaks tpu_std: the quiesce lame-duck pass may
      // answer it with a SHUTDOWN control frame (once is enough)
      if (!s->spoke_tpu_std.load(std::memory_order_relaxed)) {
        s->spoke_tpu_std.store(true, std::memory_order_relaxed);
      }
      if (handler != nullptr) {
        uint64_t t_parse = nat_now_ns();  // meta decoded, payload cut
        // per-method row ("Service.Method", details/method_status role):
        // concurrency brackets the usercode, the completion records
        // count/errors/latency into the method's own histogram
        char m[256];
        const std::string& sn = meta.request.service_name;
        const std::string& mn = meta.request.method_name;
        // oversize names truncate (nat_method_idx keys on a 51-char
        // prefix anyway) instead of all collapsing into one ""-keyed row
        size_t sl = sn.size() < sizeof(m) - 2 ? sn.size() : sizeof(m) - 2;
        memcpy(m, sn.data(), sl);
        m[sl] = '.';
        size_t mnl = mn.size() < sizeof(m) - 1 - sl ? mn.size()
                                                    : sizeof(m) - 1 - sl;
        memcpy(m + sl + 1, mn.data(), mnl);
        size_t ml = sl + 1 + mnl;
        int midx = nat_method_idx(NL_ECHO, m, ml);
        nat_method_begin(midx);
        NativeHandlerCtx ctx;
        ctx.req_payload = &payload;
        ctx.req_attachment = &attachment;
        uint32_t req_bytes = (uint32_t)(payload_size + att_size);
        (*handler)(ctx);
        uint64_t t_dispatch = nat_now_ns();
        uint32_t resp_bytes =
            (uint32_t)(ctx.resp_payload.length() +
                       ctx.resp_attachment.length());
        build_response_frame(&batch_out, meta.correlation_id, ctx.error_code,
                             ctx.error_text, std::move(ctx.resp_payload),
                             std::move(ctx.resp_attachment));
        s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
        uint64_t t_write = nat_now_ns();
        nat_lat_record(NL_ECHO, t_write - t_parse);
        nat_method_end(midx, t_write - t_parse, ctx.error_code != 0);
        if (nat_span_tick()) {
          nat_span_record(NL_ECHO, s->id, m, ml, t_recv, t_parse,
                          t_dispatch, t_write, ctx.error_code, req_bytes,
                          resp_bytes, (uint64_t)meta.request.trace_id,
                          (uint64_t)meta.request.span_id);
        }
      } else if (srv->py_lane_enabled) {
        // natcheck:allow(resacct): PyRequest self-accounts in its ctor
        PyRequest* r = new PyRequest();
        r->sock_id = s->id;
        r->cid = meta.correlation_id;
        r->compress_type = meta.compress_type;
        r->service = meta.request.service_name;
        r->method = meta.request.method_name;
        r->payload = payload.to_string();
        r->attachment = attachment.to_string();
        r->meta_bytes = std::move(meta_copy);
        r->trace_id = (uint64_t)meta.request.trace_id;
        r->parent_span_id = (uint64_t)meta.request.span_id;
        srv->enqueue_py(r);
      } else {
        build_response_frame(&batch_out, meta.correlation_id, kENOSERVICE,
                             "no such service/method on native port",
                             IOBuf(), IOBuf());
      }
    }
  }
flush:
  if (!ok) {
    // attribute the protocol error to the lane that owned the connection;
    // client sockets get nothing HERE — nat_client_errors counts failed
    // CALLS (fail_all / take_pending(ok=false) charge each one when the
    // dying socket sweeps them), so a socket-level increment on top would
    // double-count and break calls == responses + errors
    if (s->channel == nullptr || s->server != nullptr) {
      int err_id = s->h2 != nullptr      ? NS_H2_ERRORS
                   : s->http != nullptr  ? NS_HTTP_ERRORS
                   : s->redis != nullptr ? NS_REDIS_ERRORS
                                         : NS_TPU_STD_ERRORS;
      nat_counter_add(err_id, 1);
    }
  }
  if (!batch_out.empty()) {
    if (defer_out != nullptr) {
      defer_out->append(std::move(batch_out));
    } else {
      s->write(std::move(batch_out));
    }
  }
  // Round end for the ordered-reply lanes: ONLY once this round's bytes
  // are queued may py responders write directly again (with defer_out
  // the caller owns the flush and calls the round ends itself).
  if (defer_out == nullptr) {
    if (s->redis != nullptr) redis_round_end(s);
    if (s->http != nullptr) http_round_end(s);
  }
  return ok;
}

// Drain an fd to EAGAIN and process every complete frame, ON THE CALLING
// THREAD. The epoll dispatcher calls this inline (the bypass-loop shape,
// and the fork's wait_task ring-drain discipline, task_group.cpp:158-169):
// every process_input consumer is non-blocking by contract — native
// handlers must not block, py-lane delivery is a brief mutex push, and
// client completions are a butex wake — so a reader-fiber handoff per
// event burst (spawn + remote-queue + futex wake) only added latency.
// Single-reader safety holds because a socket belongs to exactly one
// dispatcher loop.
// Returns true when response bytes were queued (the caller flushes them at
// end of round).
bool drain_socket_inline(NatSocket* s) {
  IOBuf acc;  // responses of EVERY burst in this drain, flushed as one
  bool dead = false;
  while (!s->failed.load(std::memory_order_acquire)) {
    ssize_t n;
    // natfault read site: injected errno (ECONNRESET kills the socket
    // and drives the reconnect/health-check machinery; EINTR/EAGAIN
    // exercise the drain loop's retry arms), short reads (1 byte —
    // every parser must stay incremental), EOF, delays. One op per
    // read syscall, whichever of the three paths below performs it.
    NatFaultAct fra = NAT_FAULT_POINT(NF_READ);
    if (fra.action == NF_DELAY) nat_fault_delay_ms(fra.delay_ms);
    if (s->fill_req != nullptr && s->ssl_sess == nullptr) {
      // large-payload fill: the read syscall writes STRAIGHT into the
      // request buffer — zero userspace copies for the payload bytes
      PyRequest* r = s->fill_req;
      size_t want = r->big_len - s->fill_off;
      if (want > (4u << 20)) want = 4u << 20;  // grow-as-received slice
      if (fra.action == NF_SHORT) want = 1;
      if (!stream_fill_reserve(r, s->fill_off + want)) {
        dead = true;
        break;
      }
      if (fra.action == NF_ERR) {
        errno = fra.err;
        n = -1;
      } else if (fra.action == NF_EOF) {
        n = 0;
      } else {
        n = ::read(s->fd, r->big_payload + s->fill_off, want);
      }
      if (n > 0) {
        nat_counter_add(NS_SOCK_READ_BYTES, (uint64_t)n);
        s->c_in_bytes.fetch_add((uint64_t)n, std::memory_order_relaxed);
        s->c_read_calls.fetch_add(1, std::memory_order_relaxed);
        s->fill_off += (size_t)n;
        if (s->fill_off == r->big_len) {
          s->fill_req = nullptr;
          s->fill_off = 0;
          s->server->enqueue_py(r);
        }
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      if (n < 0 && errno == EINTR) continue;
      dead = true;  // EOF or hard error mid-payload
      break;
    }
    if (s->bulk_buf != nullptr && s->ssl_sess == nullptr) {
      // bulk-frame fill: the read syscall lands STRAIGHT in the pooled
      // slab (socket -> arena, zero userspace copies for the body);
      // capped at the frame remainder so the next frame's bytes stay in
      // the socket buffer for the normal path
      size_t want = s->bulk_len - s->bulk_off;
      if (fra.action == NF_SHORT) want = 1;
      if (fra.action == NF_ERR) {
        errno = fra.err;
        n = -1;
      } else if (fra.action == NF_EOF) {
        n = 0;
      } else {
        n = ::read(s->fd, s->bulk_buf + s->bulk_off, want);
      }
      if (n > 0) {
        nat_counter_add(NS_SOCK_READ_BYTES, (uint64_t)n);
        s->c_in_bytes.fetch_add((uint64_t)n, std::memory_order_relaxed);
        s->c_read_calls.fetch_add(1, std::memory_order_relaxed);
        s->bulk_off += (size_t)n;
        if (s->bulk_off == s->bulk_len) {
          bulk_fill_complete(s);
          if (!process_input(s, &acc)) {
            dead = true;
            break;
          }
        }
        continue;
      }
      if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
      if (n < 0 && errno == EINTR) continue;
      dead = true;  // EOF or hard error mid-frame
      break;
    }
    if (s->ssl_sess != nullptr) {
      // TLS lane: ciphertext goes through the session; plaintext lands
      // in in_buf inside ssl_feed
      char tmp[65536];
      if (fra.action == NF_ERR) {
        errno = fra.err;
        n = -1;
      } else if (fra.action == NF_EOF) {
        n = 0;
      } else {
        n = ::read(s->fd, tmp, fra.action == NF_SHORT ? 1 : sizeof(tmp));
      }
      if (n > 0 && !ssl_feed(s, tmp, (size_t)n)) {
        dead = true;
        break;
      }
    } else if (fra.action == NF_ERR) {
      errno = fra.err;
      n = -1;
    } else if (fra.action == NF_EOF) {
      n = 0;
    } else {
      n = s->in_buf.append_from_fd(s->fd,
                                   fra.action == NF_SHORT ? 1 : 65536);
    }
    if (n > 0) {
      nat_counter_add(NS_SOCK_READ_BYTES, (uint64_t)n);
      s->c_in_bytes.fetch_add((uint64_t)n, std::memory_order_relaxed);
      s->c_read_calls.fetch_add(1, std::memory_order_relaxed);
      if (!process_input(s, &acc)) {
        dead = true;
        break;
      }
      continue;
    }
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) break;
    if (n < 0 && errno == EINTR) continue;
    dead = true;  // EOF or hard error
    break;
  }
  // /connections memory column: buffered-but-unparsed request bytes on
  // this socket, settled once per drain (single reading thread stores,
  // the snapshot walker reads)
  s->c_rdbuf.store(s->in_buf.length(), std::memory_order_relaxed);
  bool hold_role = false;
  if (!acc.empty() && !dead && s->ssl_sess != nullptr) {
    // TLS: encrypt + queue atomically (ssl_encrypt_and_write) — a py
    // responder encrypting concurrently must not interleave records
    if (ssl_encrypt_and_write(s, std::move(acc)) != 0) dead = true;
    acc.clear();
  }
  if (!acc.empty() && !dead) {
    // wait-free enqueue; when the push wins the drain role, the CALLER
    // (the epoll dispatcher) holds it until its end-of-round flush —
    // cross-burst syscall batching with zero lock traffic. A racing
    // set_failed is fine: the role holder's flush_chain cleans up.
    hold_role = s->write_push(std::move(acc));
  }
  if (!dead) {
    // this drain's accumulator is queued: end the ordered-lane rounds
    if (s->redis != nullptr) redis_round_end(s);
    if (s->http != nullptr) http_round_end(s);
  }
  if (dead || s->failed.load(std::memory_order_acquire)) {
    if (hold_role) {
      s->write_release_all();  // we hold the drain role: clean it up
      hold_role = false;
    }
    s->set_failed();
    return false;
  }
  return hold_role;
}

}  // namespace brpc_tpu
