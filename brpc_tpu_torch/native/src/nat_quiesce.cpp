// nat_quiesce — the graceful-degradation lifecycle of the native server
// (Server::Stop(timeout)/Join, server.h:426-441, as a wire protocol):
//
//   phase 1  stop accepting: listeners unsubscribe from their dispatcher
//            loops (fd close DEFERRED to the loop thread — the accept-vs-
//            teardown race fix) and the drain gate arms, so new WORK
//            arrivals answer ELIMIT/503/RESOURCE_EXHAUSTED instead of
//            dying with a reset;
//   phase 2  lame-duck signaling on every live connection, per protocol:
//            h2 peers get GOAWAY(last_stream_id) (RFC 7540 §6.8), HTTP
//            sessions mark Connection: close onto their remaining
//            responses, tpu_std connections get a SHUTDOWN-bit control
//            frame (RpcMeta field 8, correlation_id 0), RESP sessions
//            close once their reply window drains;
//   phase 3  drain: admitted work — py-lane tpu_std requests, HTTP/h2/
//            RESP reorder-window responses, shm-worker in-flight — runs
//            to completion under the deadline; stragglers left in the py
//            queue at expiry are 503'd (never reset); sockets close only
//            once their write stack is idle (close_after_drain), so the
//            FIN always trails the last response byte.
//
// The exported entry is nat_server_quiesce(timeout_ms); rpc/server.py
// wires SIGTERM to it via the graceful_quit_on_sigterm option.
#include "nat_internal.h"

namespace brpc_tpu {

std::atomic<uint32_t> g_draining{0};
std::atomic<int64_t> g_tpu_work_live{0};

namespace {

// One pass over the socket slot space (bounded by the allocation
// high-water mark), calling fn on each live socket owned by srv. The
// borrowed reference pins the slot (and its protocol sessions) for the
// duration of fn.
template <typename Fn>
void for_each_server_socket(NatServer* srv, Fn fn) {
  uint32_t hwm;
  {
    std::lock_guard g(g_sock_alloc_mu);
    hwm = g_sock_next_idx;
  }
  for (uint32_t idx = 0; idx < hwm; idx++) {
    NatSocket* cand = sock_at(idx);
    if (cand == nullptr) continue;
    uint64_t id = cand->id;  // racy snapshot; sock_address validates it
    NatSocket* s = sock_address(id);
    if (s == nullptr) continue;
    if (s->server == srv && !s->failed.load(std::memory_order_acquire)) {
      fn(s);
    }
    NAT_REF_RELEASE(s, sock.borrow);
  }
}

// Lame-duck one connection on its own protocol. Returns true when a
// signal actually went out (the NS_QUIESCE_LAME_DUCK_SENT unit).
// Session pointers are written once by the reading thread at sniff time
// and never change until the socket recycles (which our borrowed ref
// forbids) — a connection still mid-sniff is simply missed here and
// learns about the drain from its first rejection instead.
bool socket_lame_duck(NatSocket* s) {
  if (s->h2 != nullptr) {
    h2_send_goaway(s);
    return true;
  }
  if (s->http != nullptr) {
    http_session_lame_duck(s);
    return true;
  }
  if (s->redis != nullptr) {
    redis_session_lame_duck(s);
    return true;
  }
  if (s->spoke_tpu_std.load(std::memory_order_relaxed)) {
    IOBuf f;
    build_shutdown_frame(&f);
    s->write(std::move(f));
    return true;
  }
  // raw-fallback / streaming / not-yet-sniffed connections have no
  // native protocol to speak — the final close pass flushes whatever
  // their Python responders queued, then FINs.
  return false;
}

// Count the work still owed on srv's connections. Approximate by
// design: the per-session counters under their mutexes are exact, the
// reading-thread-only halves (next_req_seq) are racy reads — the drain
// loop requires TWO consecutive quiet polls, so a transiently-torn
// read cannot end the drain early.
int drain_pending(NatServer* srv) {
  int busy = 0;
  {
    std::lock_guard g(srv->py_mu);
    busy += (int)srv->py_q.size();
  }
  int64_t live = g_tpu_work_live.load(std::memory_order_acquire);
  if (live > 0) busy += (int)live;
  if (!shm_lane_inflight_empty()) busy++;
  for_each_server_socket(srv, [&busy](NatSocket* s) {
    if (s->http != nullptr && http_session_busy(s)) busy++;
    if (s->h2 != nullptr && h2_session_busy(s)) busy++;
    if (s->redis != nullptr && redis_session_busy(s)) busy++;
    if (!s->write_idle()) busy++;
  });
  return busy;
}

}  // namespace

extern "C" {

// True while a quiesce is in progress or completed on the running
// server (observability/tests).
int nat_server_draining(void) {
  return g_draining.load(std::memory_order_acquire) != 0 ? 1 : 0;
}

// Graceful quiesce of the running native server: stop accepting,
// lame-duck every connection, drain admitted work, reject new arrivals,
// close sockets only once flushed. Blocks up to timeout_ms (<= 0 uses a
// 5s default). Returns 0 (drained clean), 1 (deadline expired —
// stragglers were 503'd), -1 (no running server). Call
// nat_rpc_server_stop afterwards to release the server; the py lane
// keeps serving during the drain.
int nat_server_quiesce(int timeout_ms) {
  NatServer* srv;
  {
    std::lock_guard g(g_rt_mu);
    srv = g_rpc_server;
    if (srv == nullptr) return -1;
    NAT_REF_ACQUIRE(srv, srv.quiesce);
    // phase 1: unsubscribe the listener from its dispatcher. The fd
    // CLOSE is deferred to the loop thread (remove_listener), so a
    // concurrently-dispatched accept can never run on a recycled fd.
    if (srv->listen_fd >= 0) {
      g_disp->remove_listener(srv->listen_fd);
      srv->listen_fd = -1;  // stop() must not tear it down again
    }
    // multi-port servers (swarm backends) stop accepting on EVERY port
    server_remove_extra_ports_locked(srv);
  }
  // arm the drain gate BEFORE signaling: a request racing the lame-duck
  // frame is rejected (wire answer), never silently dropped
  g_draining.store(1, std::memory_order_release);

  // phase 2: lame-duck every live connection on its own protocol
  for_each_server_socket(srv, [](NatSocket* s) {
    if (socket_lame_duck(s)) {
      nat_counter_add(NS_QUIESCE_LAME_DUCK_SENT, 1);
    }
  });

  // phase 3: drain admitted work under the deadline
  if (timeout_ms <= 0) timeout_ms = 5000;
  uint64_t deadline = nat_now_ns() + (uint64_t)timeout_ms * 1000000ull;
  bool expired = false;
  int quiet_polls = 0;
  while (true) {
    // natfault shutdown site: err = forced drain-deadline expiry NOW
    // (the chaos lane's straggler-drop driver), delay stretches a poll
    NatFaultAct fa = NAT_FAULT_POINT(NF_SHUTDOWN);
    if (fa.action == NF_DELAY) nat_fault_delay_ms(fa.delay_ms);
    if (fa.action == NF_ERR) {
      expired = true;
      break;
    }
    if (drain_pending(srv) == 0) {
      // two consecutive quiet polls: the racy session reads settled
      if (++quiet_polls >= 2) break;
    } else {
      quiet_polls = 0;
    }
    if (nat_now_ns() >= deadline) {
      expired = true;
      break;
    }
    struct timespec ts = {0, 2 * 1000 * 1000};  // 2ms poll
    nanosleep(&ts, nullptr);
  }

  // deadline expired: requests still queued for the py lane will never
  // be served — answer each with the overload wire shape (503/ELIMIT),
  // never a bare reset, and count the drops
  if (expired) {
    std::deque<PyRequest*> stragglers;
    {
      std::lock_guard g(srv->py_mu);
      for (auto it = srv->py_q.begin(); it != srv->py_q.end();) {
        PyRequest* r = *it;
        if (is_work_kind(r->kind)) {
          stragglers.push_back(r);
          it = srv->py_q.erase(it);
        } else {
          ++it;
        }
      }
    }
    for (PyRequest* r : stragglers) {
      nat_counter_add(NS_QUIESCE_DRAIN_DEADLINE_DROPS, 1);
      drain_reject(r);
    }
    // give the reject fibers a moment to put their 503s on the wire
    // before the close pass arms FINs behind them
    struct timespec ts = {0, 20 * 1000 * 1000};
    nanosleep(&ts, nullptr);
  } else {
    nat_counter_add(NS_QUIESCE_DRAINED_OK, 1);
  }

  // final: graceful close on every remaining connection — queued bytes
  // (the last responses, the straggler 503s) flush, then FIN
  for_each_server_socket(srv, [](NatSocket* s) {
    s->arm_close_after_drain();
  });

  NAT_REF_RELEASE(srv, srv.quiesce);
  return expired ? 1 : 0;
}

}  // extern "C"

}  // namespace brpc_tpu
