// NatChannel — the client half (brpc::Channel/Controller): correlation-id
// pending table (versioned slots, nat_internal.h), synchronous calls
// parking on a butex, per-call deadlines via the native TimerThread,
// retry-over-reconnect with a budget clamp, backup requests, and the
// background health-check revival chain (health_check.cpp:146-237).
#include "nat_internal.h"

namespace brpc_tpu {

// Return the call slot to its owning channel. The slot memory is never
// freed while the channel lives, so a straggling butex_wake on a recycled
// slot is harmlessly spurious (waiters re-check the value) — the same
// never-free property the old global pool provided, now per channel.
void pc_free(PendingCall* pc) {
  pc->response.clear();
  pc->attachment.clear();
  pc->owner->release_slot(pc->slot_idx);
}

// Non-blocking connect with a deadline — the bthread_connect discipline
// (bthread/fd.cpp:119-170): EINPROGRESS, poll for writability, then
// SO_ERROR. Returns a connected nonblocking fd (TCP_NODELAY set) or -1.
int dial_nonblocking(const char* ip, int port, int timeout_ms) {
  // natfault connect site: injected dial delay (a blackholed-peer
  // stand-in that exercises the connect-timeout clamps) or refusal.
  NatFaultAct fca = NAT_FAULT_POINT(NF_CONNECT);
  if (fca.action == NF_DELAY) {
    nat_fault_delay_ms(fca.delay_ms);
  } else if (fca.action == NF_ERR) {
    errno = fca.err != 0 ? fca.err : ECONNREFUSED;
    return -1;
  }
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, ip, &addr.sin_addr);
  int rc = connect(fd, (struct sockaddr*)&addr, sizeof(addr));
  if (rc != 0) {
    if (errno != EINPROGRESS) {
      ::close(fd);
      return -1;
    }
    struct pollfd p;
    p.fd = fd;
    p.events = POLLOUT;
    p.revents = 0;
    int t = timeout_ms > 0 ? timeout_ms : 10000;  // sane default guard
    if (poll(&p, 1, t) != 1) {
      ::close(fd);  // timed out (no blocking connect with no deadline:
      return -1;    // the round-2 nat_channel_open gap)
    }
    int err = 0;
    socklen_t l = sizeof(err);
    getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &l);
    if (err != 0) {
      ::close(fd);
      return -1;
    }
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  return fd;
}

// Borrow the channel's socket, re-dialing a failed single connection on
// demand (Channel reuse-after-failure semantics). Returns a referenced
// socket or nullptr (closed channel / peer unreachable).
NatSocket* channel_socket(NatChannel* ch, int max_dial_ms) {
  NatSocket* s = sock_address(ch->sock_id.load(std::memory_order_acquire));
  if (s != nullptr || ch->closed.load(std::memory_order_acquire) ||
      ch->peer_port == 0) {
    return s;
  }
  // Circuit breaker: while isolated, fail fast — no dial, no syscall.
  // After the isolation window the re-dial below runs; success resets
  // the breaker (the revival half of circuit_breaker.py's contract).
  if (ch->breaker_enabled.load(std::memory_order_relaxed) &&
      ch->breaker_broken.load(std::memory_order_acquire) &&
      (int64_t)(nat_now_ns() / 1000000ull) <
          ch->breaker_until_ms.load(std::memory_order_acquire)) {
    return nullptr;
  }
  // Dial OUTSIDE reconnect_mu — poll() can block up to the connect
  // timeout, and close()/other callers must not wait behind it. The
  // publish step below re-checks under the lock; a losing racer just
  // closes its dial. Re-dials default to a 1s guard (not the 10s
  // first-open guard) so a blackholed peer doesn't pin a worker long;
  // callers with a deadline pass max_dial_ms to clamp further.
  int t_ms = ch->connect_timeout_ms > 0 ? ch->connect_timeout_ms : 1000;
  if (max_dial_ms > 0 && max_dial_ms < t_ms) t_ms = max_dial_ms;
  int fd = dial_nonblocking(ch->peer_ip.c_str(), ch->peer_port, t_ms);
  if (fd < 0) return nullptr;
  std::lock_guard g(ch->reconnect_mu);
  s = sock_address(ch->sock_id.load(std::memory_order_acquire));
  if (s != nullptr || ch->closed.load(std::memory_order_acquire)) {
    ::close(fd);  // lost the race (or the channel closed mid-dial)
    return s;
  }
  NatSocket* ns = sock_create();
  if (ns == nullptr) {
    ::close(fd);
    return nullptr;
  }
  ns->fd = fd;
  sock_set_peer(ns, ch->peer_ip.c_str(), ch->peer_port);
  ns->disp = pick_dispatcher(/*client_side=*/true);
  ns->disp->sockets_owned.fetch_add(1, std::memory_order_relaxed);
  ns->channel = ch;
  NAT_REF_ACQUIRE(ch, chan.sock);
  ns->defer_writes = ch->defer_writes_flag;
  ch->sock_id.store(ns->id, std::memory_order_release);
  if (ch->protocol != 0) channel_attach_client_session(ch, ns);
  ns->conn_visible.store(true, std::memory_order_release);
  // the caller's borrowed reference, taken BEFORE epoll can fail the
  // socket — the returned ref matches sock_address's borrow contract
  NAT_REF_ACQUIRE(ns, sock.borrow);
  ns->disp->add_consumer(ns);  // client sockets stay on epoll (measured
                               // slower on the ring: one-in-flight sends
                               // throttle request pipelining)
  if (ch->breaker_broken.load(std::memory_order_acquire)) {
    ch->breaker_reset(/*revived=*/true);  // isolation served + peer back
  }
  return ns;
}

// ---------------------------------------------------------------------------
// circuit breaker (two-EMA-window port of rpc/circuit_breaker.py)
// ---------------------------------------------------------------------------

// Window shapes mirror the Python flags' defaults: short window 128
// samples / 10% error budget, long window 1024 / 5%; isolation starts
// at 100ms and doubles (capped at 30s) when re-tripped within 30s.
static constexpr double kBrkShortAlpha = 2.0 / (128 + 1);
static constexpr double kBrkLongAlpha = 2.0 / (1024 + 1);
static constexpr double kBrkShortThreshold = 0.10;
static constexpr double kBrkLongThreshold = 0.05;
static constexpr int kBrkMinIsolationMs = 100;
static constexpr int kBrkMaxIsolationMs = 30000;

void NatChannel::breaker_on_call_end(bool call_ok) {
  bool trip = false;
  {
    std::lock_guard g(breaker_mu);
    if (breaker_broken.load(std::memory_order_relaxed)) return;
    double sample = call_ok ? 0.0 : 1.0;
    brk_short_ema =
        (1.0 - kBrkShortAlpha) * brk_short_ema + kBrkShortAlpha * sample;
    brk_long_ema =
        (1.0 - kBrkLongAlpha) * brk_long_ema + kBrkLongAlpha * sample;
    if (brk_short_ema >= kBrkShortThreshold ||
        brk_long_ema >= kBrkLongThreshold) {
      int64_t now_ms = (int64_t)(nat_now_ns() / 1000000ull);
      if (brk_last_isolation_ms != 0 &&
          now_ms - brk_last_isolation_ms < 30000) {
        brk_isolation_ms = brk_isolation_ms * 2 < kBrkMaxIsolationMs
                               ? brk_isolation_ms * 2
                               : kBrkMaxIsolationMs;
      } else {
        brk_isolation_ms = kBrkMinIsolationMs;
      }
      if (brk_isolation_ms < kBrkMinIsolationMs) {
        brk_isolation_ms = kBrkMinIsolationMs;
      }
      brk_last_isolation_ms = now_ms;
      breaker_until_ms.store(now_ms + brk_isolation_ms,
                             std::memory_order_release);
      breaker_broken.store(true, std::memory_order_release);
      trip = true;
    }
  }
  if (trip) {
    nat_counter_add(NS_BREAKER_ISOLATIONS, 1);
    // isolate OUTSIDE breaker_mu: set_failed sweeps pendings and arms
    // the health-check revival chain, which owns bringing the node back
    NatSocket* s = sock_address(sock_id.load(std::memory_order_acquire));
    if (s != nullptr) {
      s->set_failed();
      NAT_REF_RELEASE(s, sock.borrow);
    }
  }
}

void NatChannel::breaker_reset(bool revived) {
  bool was_broken;
  {
    std::lock_guard g(breaker_mu);
    brk_short_ema = 0.0;
    brk_long_ema = 0.0;
    // exchange under the mutex: concurrent post-isolation dialers both
    // see broken==true before the reset, but exactly one wins the
    // revival (the counter must advance once per actual revival)
    was_broken = breaker_broken.exchange(false, std::memory_order_acq_rel);
  }
  if (revived && was_broken) nat_counter_add(NS_BREAKER_REVIVALS, 1);
}

// A peer signaled lame duck on `s` (SHUTDOWN meta bit, h2 GOAWAY, HTTP
// Connection: close): detach the socket from the channel so NEW calls
// dial a fresh connection (or re-balance at the LB layer) while
// in-flight calls keep completing on the old one. A planned removal:
// no breaker sample, no retry-budget burn, and — because the detached
// socket's eventual death never enters the sock_id==id arm of
// set_failed — no fail_all sweep and no health-check alarm.
void channel_note_lame_duck(NatChannel* ch, NatSocket* s) {
  if (ch == nullptr) return;
  ch->lame_duck_ms.store((int64_t)(nat_now_ns() / 1000000ull),
                         std::memory_order_relaxed);
  uint64_t expect = s->id;
  if (ch->sock_id.compare_exchange_strong(expect, 0,
                                          std::memory_order_seq_cst)) {
    nat_counter_add(NS_QUIESCE_DRAINING_REDIALS, 1);
  }
}

// Connection: close from a NOT-previously-keep-alive connection (a
// close-per-response backend, not a drain signal): detach so new calls
// dial fresh — reusing the socket would race the server's FIN — but
// WITHOUT the planned-churn classification: no draining window, no
// NS_QUIESCE accounting, breaker/retry-budget sampling stays live.
void channel_detach_socket(NatChannel* ch, NatSocket* s) {
  if (ch == nullptr) return;
  uint64_t expect = s->id;
  ch->sock_id.compare_exchange_strong(expect, 0,
                                      std::memory_order_seq_cst);
}

// Background revival of a failed channel connection (the health-check
// thread role, health_check.cpp:146-237): re-dial every interval until
// the channel closes or the connection is back. The dial can block up to
// connect_timeout_ms, so it runs on a scheduler FIBER — timer callbacks
// must not block (a blackholed peer would stall every armed deadline).
static void health_check_dial_fiber(void* raw) {
  NatChannel* ch = (NatChannel*)raw;
  if (ch->closed.load(std::memory_order_acquire)) {
    ch->hc_pending.store(false, std::memory_order_release);
    NAT_REF_RELEASE(ch, chan.revival);
    return;
  }
  NatSocket* s = channel_socket(ch);
  if (s != nullptr) {  // revived (or never died)
    NAT_REF_RELEASE(s, sock.borrow);
    ch->hc_backoff_shift.store(0, std::memory_order_relaxed);
    ch->hc_pending.store(false, std::memory_order_release);
    NAT_REF_RELEASE(ch, chan.revival);
    return;
  }
  // Exponential backoff with jitter: a dead peer must not be hammered
  // at a fixed rate by every client holding a channel to it. The first
  // retry fired at the base interval (set_failed resets the shift);
  // failures double the delay up to min(64x interval, 30s), and a
  // ±25% deterministic dither decorrelates channels that failed
  // together (the retry-dispersal concern, applied to revival probes).
  int shift = ch->hc_backoff_shift.load(std::memory_order_relaxed);
  int64_t base = ch->health_check_interval_ms > 0
                     ? ch->health_check_interval_ms
                     : 1;
  int64_t cap = base * 64 < 30000 ? base * 64 : 30000;
  if (cap < base) cap = base;
  int64_t delay = base << (shift < 6 ? shift : 6);
  if (delay > cap) delay = cap;
  uint64_t h =
      nat_mix64((uint64_t)(uintptr_t)ch ^ ((uint64_t)(shift + 1) << 48));
  int64_t jitter = (int64_t)(h % (uint64_t)(delay / 2 + 1)) - delay / 4;
  delay += jitter;
  if (delay < 1) delay = 1;
  ch->hc_backoff_shift.store(shift < 6 ? shift + 1 : 6,
                             std::memory_order_relaxed);
  TimerThread::instance()->schedule(health_check_fire, ch, (int)delay);
}

void health_check_fire(void* raw) {
  Scheduler::instance()->spawn_detached(health_check_dial_fiber, raw);
}

// Per-call deadline (the bthread_timer_add arming of controller.cpp:605):
// the timer races the response through the SAME pending-bit CAS — whoever
// wins owns the completion, so a late reply after a timeout (or a timeout
// firing after completion) is a harmless no-op. No unschedule needed.
struct CallTimeout {
  NatChannel* ch;  // holds a reference until the timer fires
  int64_t cid;
};

static void call_timeout_work(void* raw) {
  CallTimeout* t = (CallTimeout*)raw;
  PendingCall* pc = t->ch->take_pending(t->cid, /*ok=*/false);
  if (pc != nullptr) {
    pc->error_code = kERPCTIMEDOUT;
    pc->error_text = "rpc timed out";
    if (pc->cb != nullptr) {
      pc->cb(pc, pc->cb_arg);  // cb owns pc
    } else {
      pc->done.value.store(1, std::memory_order_release);
      Scheduler::butex_wake(&pc->done, INT32_MAX);
    }
  }
  NAT_REF_RELEASE(t->ch, chan.timer);
  delete t;
}

// The completion callback may run arbitrary embedder code (the Python
// acall trampoline takes the GIL): run it on a scheduler fiber — timer
// callbacks must not block or every later deadline fires late.
static void call_timeout_fire(void* raw) {
  Scheduler::instance()->spawn_detached(call_timeout_work, raw);
}

void arm_call_timeout(NatChannel* ch, int64_t cid, int timeout_ms) {
  NAT_REF_ACQUIRE(ch, chan.timer);  // call_timeout_work releases
  TimerThread::instance()->schedule(call_timeout_fire,
                                    new CallTimeout{ch, cid}, timeout_ms);
}

// Open-channel registry for the builtin.stats snapshot: explicitly
// opened client channels enter at open and leave at close (the opener
// reference keeps the pointer valid in between, so the walk never races
// a delete). Cluster lazy-created backends do NOT register — their
// breaker/lame-duck state already surfaces through the cluster stats
// rows, and the fleet collector reads those from its own NativeCluster.
static NatMutex<kLockRankChanReg> g_chan_reg_mu;
// natcheck:leak(g_chan_reg): leaked like every runtime static — a
// static-dtor order race against late channel closes (py atexit) would
// walk a destructed vector; process exit reclaims it anyway
static std::vector<NatChannel*>& g_chan_reg = *new std::vector<NatChannel*>();

static void chan_reg_add(NatChannel* ch) {
  std::lock_guard g(g_chan_reg_mu);
  g_chan_reg.push_back(ch);
}

static void chan_reg_remove(NatChannel* ch) {
  std::lock_guard g(g_chan_reg_mu);
  for (size_t i = 0; i < g_chan_reg.size(); i++) {
    if (g_chan_reg[i] == ch) {
      g_chan_reg[i] = g_chan_reg.back();
      g_chan_reg.pop_back();
      return;
    }
  }
}

// Snapshot rows (see nat_stats.h): JSON array of open channels. Reads
// immutable open-time fields (peer, protocol) and atomics only — no
// channel lock is taken under g_chan_reg_mu.
void nat_channels_snapshot_json(std::string* out) {
  out->append("[");
  std::lock_guard g(g_chan_reg_mu);
  for (size_t i = 0; i < g_chan_reg.size(); i++) {
    NatChannel* ch = g_chan_reg[i];
    char row[192];
    snprintf(row, sizeof(row),
             "%s{\"peer\":\"%s:%d\",\"protocol\":%d,"
             "\"breaker_enabled\":%d,\"breaker_broken\":%d,"
             "\"lame_duck\":%d,\"retry_budget_decis\":%d}",
             i == 0 ? "" : ",", ch->peer_ip.c_str(), ch->peer_port,
             ch->protocol,
             ch->breaker_enabled.load(std::memory_order_relaxed) ? 1 : 0,
             ch->breaker_broken.load(std::memory_order_acquire) ? 1 : 0,
             ch->draining_recent() ? 1 : 0,
             ch->retry_budget_decis.load(std::memory_order_relaxed));
    out->append(row);
  }
  out->append("]");
}

// Shared open path: the client session (and ch->protocol) must be fully
// attached BEFORE the socket joins epoll — a spec-compliant h2 server
// sends SETTINGS immediately on accept, and the dispatcher must never
// observe a protocol!=0 channel with a null session (or route
// server-first bytes into the tpu_std parser).
static void* channel_open_impl(const char* ip, int port, int nworkers,
                               int batch_writes, int connect_timeout_ms,
                               int health_check_ms, int protocol,
                               const char* authority) {
  if (ensure_runtime(nworkers) != 0) return nullptr;
  int fd = dial_nonblocking(ip, port, connect_timeout_ms);
  if (fd < 0) return nullptr;

  NatChannel* ch = new NatChannel();
  NAT_REF_ACQUIRED(ch, chan.opener);  // ref{1} = the opener's reference
  ch->peer_ip = ip;
  ch->peer_port = port;
  ch->connect_timeout_ms = connect_timeout_ms;
  ch->health_check_interval_ms = health_check_ms;
  ch->defer_writes_flag = (batch_writes != 0);
  ch->protocol = protocol;
  if (authority != nullptr && authority[0] != '\0') {
    ch->authority = authority;
  } else if (protocol != 0) {
    char buf[64];
    snprintf(buf, sizeof(buf), "%s:%d", ip, port);
    ch->authority = buf;
  }
  NatSocket* s = sock_create();
  if (s == nullptr) {
    ::close(fd);
    NAT_REF_RELEASE(ch, chan.opener);
    return nullptr;
  }
  s->fd = fd;
  sock_set_peer(s, ip, port);
  s->disp = pick_dispatcher(/*client_side=*/true);
  s->disp->sockets_owned.fetch_add(1, std::memory_order_relaxed);
  s->channel = ch;
  NAT_REF_ACQUIRE(ch, chan.sock);  // dropped in NatSocket::release
  s->defer_writes = (batch_writes != 0);
  ch->sock_id.store(s->id, std::memory_order_release);
  if (protocol != 0) channel_attach_client_session(ch, s);
  s->conn_visible.store(true, std::memory_order_release);
  // NOT ring-adopted: measured slower for clients — the one-in-flight
  // fixed-send discipline throttles request pipelining, while the epoll
  // lane's writer fiber flushes the whole queue per writev
  s->disp->add_consumer(s);
  chan_reg_add(ch);
  return ch;
}

extern "C" {

void* nat_channel_open(const char* ip, int port, int nworkers,
                       int batch_writes, int connect_timeout_ms,
                       int health_check_ms) {
  return channel_open_impl(ip, port, nworkers, batch_writes,
                           connect_timeout_ms, health_check_ms, 0, nullptr);
}

void* nat_channel_open_proto(const char* ip, int port, int nworkers,
                             int batch_writes, int connect_timeout_ms,
                             int health_check_ms, int protocol,
                             const char* authority) {
  return channel_open_impl(ip, port, nworkers, batch_writes,
                           connect_timeout_ms, health_check_ms, protocol,
                           authority);
}

void nat_channel_close(void* h) {
  NatChannel* ch = (NatChannel*)h;
  chan_reg_remove(ch);
  {
    // serialize against an in-flight reconnect: once we hold
    // reconnect_mu, any racing channel_socket has either published its
    // new socket (we fail it below) or will see closed and not dial
    std::lock_guard g(ch->reconnect_mu);
    ch->closed.store(true, std::memory_order_release);
  }
  NatSocket* s = sock_address(ch->sock_id);
  if (s != nullptr) {
    s->set_failed();  // fails pending calls via channel->fail_all
    NAT_REF_RELEASE(s, sock.borrow);
  }
  ch->fail_all(kEFAILEDSOCKET, "channel closed");
  // the socket may still hold its chan.sock reference
  NAT_REF_RELEASE(ch, chan.opener);
}

// Backup request (the controller.cpp:1256 backup timer): when the timer
// fires and the call is STILL pending, the SAME frame (same correlation
// id) is re-sent on the channel's current socket — the pending-bit CAS
// makes whichever response lands first win and the loser a no-op, which
// is exactly the reference's duplicate-response discipline.
struct BackupCtx {
  NatChannel* ch;  // holds a reference until fired
  int64_t cid;
  std::string frame;
};

static void backup_fire_work(void* raw) {
  BackupCtx* b = (BackupCtx*)raw;
  if (b->ch->is_pending(b->cid) &&
      !b->ch->closed.load(std::memory_order_acquire)) {
    NatSocket* s = sock_address(b->ch->sock_id);
    if (s != nullptr) {
      IOBuf f;
      f.append(b->frame.data(), b->frame.size());
      if (s->write(std::move(f)) == 0) {
        s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
      }
      NAT_REF_RELEASE(s, sock.borrow);
    }
  }
  NAT_REF_RELEASE(b->ch, chan.backup);
  delete b;
}

static void backup_fire(void* raw) {
  Scheduler::instance()->spawn_detached(backup_fire_work, raw);
}

// Channel-wide retry clamp: a retry costs 10 deci-tokens from the
// budget successes replenish (note_call_success), so an injected
// failure burst cannot amplify into a retry storm — once the budget is
// dry, failures surface instead of multiplying wire attempts.
static bool take_retry_token(NatChannel* ch) {
  int v = ch->retry_budget_decis.fetch_sub(10, std::memory_order_acq_rel);
  if (v < 10) {
    ch->retry_budget_decis.fetch_add(10, std::memory_order_acq_rel);
    nat_counter_add(NS_RETRY_BUDGET_EXHAUSTED, 1);
    return false;
  }
  return true;
}

// One wire attempt: build, (optionally) arm deadline + backup, write,
// park, harvest. Returns the RPC error code.
static int call_attempt(NatChannel* ch, NatSocket* s, const char* service,
                        const char* method, const char* payload,
                        size_t payload_len, int timeout_ms, int backup_ms,
                        char** resp_out, size_t* resp_len,
                        char** err_text_out) {
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(service, ".", method);
  int64_t cid = 0;
  PendingCall* pc = ch->begin_call(&cid, nullptr, nullptr, &tr);
  if (pc == nullptr) {
    return kEFAILEDSOCKET;  // 1M calls already in flight on this channel
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  IOBuf frame;
  build_request_frame(&frame, cid, service, method, payload, payload_len,
                      nullptr, 0, tr.trace_id, tr.span_id);
  if (backup_ms > 0 && (timeout_ms <= 0 || backup_ms < timeout_ms)) {
    NAT_REF_ACQUIRE(ch, chan.backup);  // backup_fire_work releases
    BackupCtx* b = new BackupCtx{ch, cid, frame.to_string()};
    TimerThread::instance()->schedule(backup_fire, b, backup_ms);
  }
  if (s->write(std::move(frame)) == 0) {
    s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  } else {
    PendingCall* mine = ch->take_pending(cid, /*ok=*/false);
    if (mine != nullptr) {
      pc_free(mine);
    } else {
      // fail_all consumed it and is completing through the wake path;
      // wait for that completion so the object isn't leaked
      while (pc->done.value.load(std::memory_order_acquire) == 0) {
        Scheduler::butex_wait(&pc->done, 0);
      }
      pc_free(pc);
    }
    return kEFAILEDSOCKET;
  }
  while (pc->done.value.load(std::memory_order_acquire) == 0) {
    Scheduler::butex_wait(&pc->done, 0);
  }
  int rc = pc->error_code;
  if (rc == 0 && resp_out != nullptr) {
    *resp_len = pc->inline_len > 0 ? pc->inline_len
                                   : pc->response.length();
    *resp_out = (char*)malloc(*resp_len ? *resp_len : 1);
    if (pc->inline_len > 0) {
      memcpy(*resp_out, pc->inline_resp, pc->inline_len);
    } else {
      pc->response.copy_to(*resp_out, *resp_len);
    }
  } else if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) {
    if (rc != 0 && !pc->error_text.empty()) {
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

// Synchronous call. Returns 0 on success (out buffers malloc'd, caller
// frees with nat_buf_free), else an error code. timeout_ms > 0 arms a
// deadline covering ALL attempts (reference semantics); failed-socket
// attempts retry up to max_retry times with on-demand re-dial;
// backup_ms > 0 re-sends the request if no response arrived in time.
int nat_channel_call_full(void* h, const char* service, const char* method,
                          const char* payload, size_t payload_len,
                          int timeout_ms, int max_retry, int backup_ms,
                          char** resp_out, size_t* resp_len,
                          char** err_text_out) {
  NatChannel* ch = (NatChannel*)h;
  // out-params are read (and freed) by the retry loop below: they must
  // be defined regardless of which early path an attempt takes
  if (resp_out != nullptr) {
    *resp_out = nullptr;
    *resp_len = 0;
  }
  if (err_text_out != nullptr) *err_text_out = nullptr;
  int64_t deadline_us =
      timeout_ms > 0
          ? std::chrono::duration_cast<std::chrono::microseconds>(
                std::chrono::steady_clock::now().time_since_epoch())
                    .count() +
                (int64_t)timeout_ms * 1000
          : 0;
  int attempt = 0;
  while (true) {
    int remaining_ms = timeout_ms;
    if (deadline_us != 0) {
      int64_t now_us =
          std::chrono::duration_cast<std::chrono::microseconds>(
              std::chrono::steady_clock::now().time_since_epoch())
              .count();
      remaining_ms = (int)((deadline_us - now_us) / 1000);
      if (remaining_ms <= 0) return kERPCTIMEDOUT;
    }
    // NOTE: the socket reference is held until the attempt completes —
    // it pins the channel (socket->channel ref), so a concurrent close
    // can never delete the slot slabs under a parked caller (the
    // never-freed-butex discipline). The re-dial is clamped to the
    // remaining budget, and the budget is recomputed after it, so a
    // slow dial can't stretch the overall deadline.
    NatSocket* s = channel_socket(ch, remaining_ms);
    if (s == nullptr) {
      // breaker isolation: fail fast — no dial happened, so spinning
      // the retry loop (and spending budget tokens on zero wire
      // attempts) would only starve the budget for real retries when
      // the peer revives
      if (ch->breaker_enabled.load(std::memory_order_relaxed) &&
          ch->breaker_broken.load(std::memory_order_acquire)) {
        return kEFAILEDSOCKET;
      }
      bool planned = ch->draining_recent();
      if (attempt++ < max_retry &&
          !ch->closed.load(std::memory_order_acquire) &&
          // planned churn (recent lame duck): re-dials toward the
          // restarting peer don't spend the budget real failures need
          (planned || take_retry_token(ch))) {
        if (planned) {
          // pace the redial so the retry window actually spans the
          // peer's restart instead of burning attempts in microseconds
          struct timespec ts = {0, 20 * 1000 * 1000};
          nanosleep(&ts, nullptr);
        }
        continue;  // the next channel_socket re-dials
      }
      return kEFAILEDSOCKET;
    }
    if (deadline_us != 0) {  // the dial may have consumed budget
      int64_t now_us =
          std::chrono::duration_cast<std::chrono::microseconds>(
              std::chrono::steady_clock::now().time_since_epoch())
              .count();
      remaining_ms = (int)((deadline_us - now_us) / 1000);
      if (remaining_ms <= 0) {
        NAT_REF_RELEASE(s, sock.borrow);
        return kERPCTIMEDOUT;
      }
    }
    int rc = call_attempt(ch, s, service, method, payload, payload_len,
                          remaining_ms, backup_ms, resp_out, resp_len,
                          err_text_out);
    NAT_REF_RELEASE(s, sock.borrow);
    // A drain-window ELIMIT from a lame-duck peer is PLANNED churn: the
    // call retries (against the re-dialed/restarted peer) without
    // spending the retry budget — graceful restarts must not eat the
    // budget real failures need.
    bool planned_retry = rc == kELIMIT && ch->draining_recent();
    if ((rc != kEFAILEDSOCKET && !planned_retry) ||
        attempt++ >= max_retry ||
        ch->closed.load(std::memory_order_acquire) ||
        (!planned_retry && !take_retry_token(ch))) {
      return rc;
    }
    if (err_text_out != nullptr && *err_text_out != nullptr) {
      free(*err_text_out);  // superseded by the retry
      *err_text_out = nullptr;
    }
  }
}

int nat_channel_call(void* h, const char* service, const char* method,
                     const char* payload, size_t payload_len, int timeout_ms,
                     char** resp_out, size_t* resp_len,
                     char** err_text_out) {
  return nat_channel_call_full(h, service, method, payload, payload_len,
                               timeout_ms, 0, 0, resp_out, resp_len,
                               err_text_out);
}

void nat_buf_free(char* p) { free(p); }

// Per-channel circuit breaker toggle (default off — single-connection
// channels in tests would otherwise isolate themselves on deliberate
// failure storms). Disabling also clears a live isolation.
int nat_channel_set_breaker(void* h, int enable) {
  NatChannel* ch = (NatChannel*)h;
  ch->breaker_enabled.store(enable != 0, std::memory_order_release);
  if (enable == 0) ch->breaker_reset(/*revived=*/false);
  return 0;
}

// 0 = closed (healthy), 1 = broken (isolated or awaiting revival).
int nat_channel_breaker_state(void* h) {
  return ((NatChannel*)h)->breaker_broken.load(std::memory_order_acquire)
             ? 1
             : 0;
}

// Remaining retry budget in deci-tokens (one retry costs 10).
int nat_channel_retry_budget(void* h) {
  return ((NatChannel*)h)
      ->retry_budget_decis.load(std::memory_order_relaxed);
}

// Asynchronous call for embedders (the done-closure surface): cb runs on
// a framework thread/fiber when the response (or failure) arrives —
// cb(user_arg, error_code, resp_bytes, resp_len). The response buffer is
// only valid during the callback; copy it out if needed. (nat_acall_cb is
// declared in nat_api.h beside the rest of the C surface.)

struct AcallCtx {
  nat_acall_cb cb;
  void* arg;
};

static void acall_complete(PendingCall* pc, void* raw) {
  AcallCtx* ctx = (AcallCtx*)raw;
  if (pc->inline_len > 0) {
    ctx->cb(ctx->arg, pc->error_code, pc->inline_resp, pc->inline_len);
  } else {
    std::string resp = pc->response.to_string();
    ctx->cb(ctx->arg, pc->error_code, resp.data(), resp.size());
  }
  pc_free(pc);
  delete ctx;
}

int nat_channel_acall(void* h, const char* service, const char* method,
                      const char* payload, size_t payload_len,
                      int timeout_ms, nat_acall_cb cb, void* arg) {
  NatChannel* ch = (NatChannel*)h;
  NatSocket* s = channel_socket(ch);
  if (s == nullptr) return kEFAILEDSOCKET;
  AcallCtx* ctx = new AcallCtx{cb, arg};
  NatCallTrace tr = nat_begin_call_trace();
  tr.set_label(service, ".", method);
  int64_t cid = 0;
  if (ch->begin_call(&cid, acall_complete, ctx, &tr) == nullptr) {
    NAT_REF_RELEASE(s, sock.borrow);
    delete ctx;
    return kEFAILEDSOCKET;
  }
  if (timeout_ms > 0) arm_call_timeout(ch, cid, timeout_ms);
  IOBuf frame;
  build_request_frame(&frame, cid, service, method, payload, payload_len,
                      nullptr, 0, tr.trace_id, tr.span_id);
  if (s->write(std::move(frame)) == 0) {
    s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
  } else {
    PendingCall* mine = ch->take_pending(cid, /*ok=*/false);  // s still pins the channel
    if (mine != nullptr) {
      // not yet consumed: complete through the SAME callback path so the
      // caller observes exactly ONE completion (returning an error here
      // while fail_all might also fire cb would double-complete, and the
      // caller would have no reason to keep the callback alive)
      mine->error_code = kEFAILEDSOCKET;
      mine->error_text = "socket failed before write";
      acall_complete(mine, ctx);
    }
    // else: fail_all already delivered the failure through cb
    NAT_REF_RELEASE(s, sock.borrow);
    return 0;
  }
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
