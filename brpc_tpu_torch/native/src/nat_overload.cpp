// nat_overload — native server admission control + queue-deadline drop.
//
// The native server lane had NO overload protection: ELIMIT (2004)
// existed only in brpc_tpu/rpc/errors.py and never on the native wire.
// This TU ports the Python limiters (rpc/concurrency_limiter.py —
// themselves the shape of brpc's ConstantLimiter and the gradient
// policy/auto_concurrency_limiter, cf. DAGOR-style overload control) to
// the C++ runtime:
//
//   * constant limiter — fixed max in-flight work requests;
//   * auto (gradient) limiter — EMA of no-load latency + windowed qps,
//     limit ≈ capacity * (1 + alpha), min-latency re-probed periodically;
//   * queue-deadline drop — requests that sat in the py queue past the
//     budget are rejected BEFORE dispatch (take_py / take_py_batch), so
//     a burst cannot convert into unbounded tail latency;
//   * real wire rejections — tpu_std ELIMIT(2004) frames, HTTP 503,
//     gRPC RESOURCE_EXHAUSTED(8), RESP -ERR — emitted from the enqueue
//     path (no locks held there; see the nat_http/nat_h2 call sites).
//
// Accounting: one in-flight token per admitted work request, released
// exactly once — by ~PyRequest for the in-process lane, or by the shm
// in-flight table's erase sites once the request rides the worker rings
// (shm_lane_offer transfers the token). The gate itself is one relaxed
// load (g_overload_on) when nothing is configured.
#include "nat_internal.h"

namespace brpc_tpu {

std::atomic<uint32_t> g_overload_on{0};

namespace {

// limiter modes
enum : int { kAdmOff = 0, kAdmConstant = 1, kAdmAuto = 2 };

std::atomic<int> g_adm_mode{kAdmOff};
std::atomic<int> g_adm_limit{0};     // effective limit (auto: computed)
std::atomic<int> g_adm_inflight{0};
std::atomic<int64_t> g_queue_deadline_ms{0};

// gradient-limiter window state (AutoLimiter port), under g_adm_mu
constexpr double kAdmAlpha = 0.3;    // headroom over measured capacity
constexpr double kAdmEmaA = 0.1;
constexpr uint64_t kAdmWindowNs = 1000000000ull;  // 1s sample window
constexpr int kAdmMinLimit = 4;
NatMutex<kLockRankOverload> g_adm_mu;
double g_min_latency_us = -1.0;      // <0 = unset
uint64_t g_window_start_ns = 0;
uint64_t g_window_count = 0;
double g_window_latency_sum_us = 0.0;
int g_probe_countdown = 10;

void overload_recompute_gate() {
  uint32_t on = (g_adm_mode.load(std::memory_order_relaxed) != kAdmOff ||
                 g_queue_deadline_ms.load(std::memory_order_relaxed) > 0)
                    ? 1u
                    : 0u;
  g_overload_on.store(on, std::memory_order_release);
}

// The rejection wire emit runs on a detached FIBER, never inline: the
// enqueue gate fires from cut-loop contexts, and the protocol
// responders take session/reorder-window locks — decoupling makes the
// rejection path deadlock-free by construction no matter which lock the
// rejecting thread holds (and keeps the static lockorder graph clean).
enum : int { kRejLimit = 0, kRejDeadline = 1, kRejDraining = 2 };

struct RejectCtx {
  int32_t kind;
  uint64_t sock_id;
  int64_t cid;
  int mode;  // kRej*
};

void overload_reject_fiber(void* raw) {
  RejectCtx* c = (RejectCtx*)raw;
  const char* text = c->mode == kRejDeadline ? "queue deadline exceeded"
                     : c->mode == kRejDraining
                         ? "server draining (lame duck)"
                         : "max concurrency reached";
  switch (c->kind) {
    case 0: {  // tpu_std: a real ELIMIT frame on the wire
      NatSocket* s = sock_address(c->sock_id);
      if (s != nullptr) {
        IOBuf out;
        if (c->mode == kRejDraining) {
          // drain-window rejections carry the SHUTDOWN bit: the client
          // learns to redial even if it missed the lame-duck frame
          build_reject_draining_frame(&out, c->cid, kELIMIT, text);
        } else {
          build_response_frame(&out, c->cid, kELIMIT, text, IOBuf(),
                               IOBuf());
        }
        s->write(std::move(out));
        NAT_REF_RELEASE(s, sock.borrow);
      }
      break;
    }
    case 3: {  // HTTP: 503 through the session's ordered reorder window
      char resp[192];
      int n = snprintf(resp, sizeof(resp),
                       "HTTP/1.1 503 Service Unavailable\r\n"
                       "Content-Type: text/plain\r\n"
                       "Content-Length: %zu\r\n\r\n%s\n",
                       strlen(text) + 1, text);
      nat_http_respond(c->sock_id, c->cid, resp, (size_t)n, 0);
      break;
    }
    case 4:  // gRPC: RESOURCE_EXHAUSTED trailers on the h2 stream
      nat_grpc_respond(c->sock_id, c->cid, nullptr, 0, 8, text);
      break;
    case 6: {  // RESP error reply through the ordered redis window
      char err[128];
      int n = snprintf(err, sizeof(err), "-ERR %s\r\n", text);
      nat_redis_respond(c->sock_id, c->cid, err, (size_t)n);
      break;
    }
    default:
      break;
  }
  delete c;
}

void emit_overload_reject(PyRequest* r, int mode) {
  nat_counter_add(mode == kRejDeadline ? NS_QUEUE_DEADLINE_DROPS
                                       : NS_ELIMIT_REJECTS,
                  1);
  Scheduler::instance()->spawn_detached(
      overload_reject_fiber,
      new RejectCtx{r->kind, r->sock_id, r->cid, mode});
}

}  // namespace

bool overload_admit(PyRequest* r) {
  if (!is_work_kind(r->kind)) return true;
  r->enqueue_ns = nat_now_ns();
  if (g_adm_mode.load(std::memory_order_relaxed) == kAdmOff) return true;
  int limit = g_adm_limit.load(std::memory_order_relaxed);
  int cur = g_adm_inflight.fetch_add(1, std::memory_order_acq_rel);
  if (limit > 0 && cur >= limit) {
    g_adm_inflight.fetch_sub(1, std::memory_order_acq_rel);
    emit_overload_reject(r, kRejLimit);
    delete r;
    return false;
  }
  r->admitted = true;
  // the in-flight token: ~PyRequest (or overload_expire) releases it,
  // unless shm_lane_offer transfers it onto the InflightEntry
  NAT_REF_ACQUIRED(nat_ref_adm_anchor(), adm.pyreq);
  return true;
}

bool overload_expired(const PyRequest* r, uint64_t now_ns) {
  if (!is_work_kind(r->kind) || r->enqueue_ns == 0) return false;
  int64_t ms = g_queue_deadline_ms.load(std::memory_order_relaxed);
  return ms > 0 && now_ns - r->enqueue_ns > (uint64_t)ms * 1000000ull;
}

void overload_expire(PyRequest* r) {
  emit_overload_reject(r, kRejDeadline);
  if (r->admitted) {
    r->admitted = false;  // expired work never feeds the limiter window
    NAT_REF_RELEASED(nat_ref_adm_anchor(), adm.pyreq);
    admission_on_complete(0, false);
  }
  delete r;
}

// Drain-window rejection (nat_quiesce.cpp's gate): same wire shapes as
// overload shed, but the tpu_std frame also carries the SHUTDOWN bit so
// the rejected client re-dials/re-balances instead of hammering a
// draining peer.
void drain_reject(PyRequest* r) {
  emit_overload_reject(r, kRejDraining);
  delete r;
}

void admission_on_complete(uint64_t latency_ns, bool ok) {
  // CAS-clamped decrement: stale tokens after an overload_server_reset
  // (server restart with requests still held by Python) release into a
  // zeroed counter and must saturate at 0 — a fetch_sub + store(0)
  // repair could stomp a concurrent admit's increment
  int v = g_adm_inflight.load(std::memory_order_relaxed);
  while (!g_adm_inflight.compare_exchange_weak(
      v, v > 0 ? v - 1 : 0, std::memory_order_acq_rel)) {
  }
  if (!ok || latency_ns == 0 ||
      g_adm_mode.load(std::memory_order_relaxed) != kAdmAuto) {
    return;
  }
  // gradient window (AutoLimiter.on_response shape, us domain)
  std::lock_guard g(g_adm_mu);
  uint64_t now = nat_now_ns();
  if (g_window_start_ns == 0) g_window_start_ns = now;
  g_window_count++;
  g_window_latency_sum_us += (double)latency_ns / 1000.0;
  uint64_t dt = now - g_window_start_ns;
  if (dt < kAdmWindowNs || g_window_count == 0) return;
  double qps = (double)g_window_count / ((double)dt / 1e9);
  double avg_latency_us = g_window_latency_sum_us / (double)g_window_count;
  g_window_start_ns = now;
  g_window_count = 0;
  g_window_latency_sum_us = 0.0;
  if (g_min_latency_us < 0.0) {
    g_min_latency_us = avg_latency_us;
  } else if (--g_probe_countdown <= 0) {
    // re-probe: adopt the fresh average so a permanently-slower backend
    // doesn't pin an unreachably-old minimum
    g_probe_countdown = 10;
    g_min_latency_us = avg_latency_us;
  } else {
    double ema = (1.0 - kAdmEmaA) * g_min_latency_us +
                 kAdmEmaA * avg_latency_us;
    if (ema < g_min_latency_us) g_min_latency_us = ema;
  }
  double capacity = qps * (g_min_latency_us / 1e6);
  double lim = capacity * (1.0 + kAdmAlpha);
  if (lim < kAdmMinLimit) lim = kAdmMinLimit;
  g_adm_limit.store((int)lim, std::memory_order_relaxed);
}

void overload_server_reset() {
  g_adm_inflight.store(0, std::memory_order_relaxed);
}

extern "C" {

// Configure the native server limiter: "" / "none" / "0" = off,
// "auto" = gradient limiter, "constant:N" or "N" = fixed limit.
// Returns 0, or -1 on an unparsable spec.
int nat_rpc_server_limiter(const char* spec) {
  int mode = kAdmOff;
  int limit = 0;
  if (spec == nullptr || spec[0] == '\0' || strcmp(spec, "none") == 0 ||
      strcmp(spec, "0") == 0) {
    mode = kAdmOff;
  } else if (strcmp(spec, "auto") == 0) {
    mode = kAdmAuto;
    limit = 64;  // AutoLimiter's initial limit; the window refines it
  } else {
    const char* num = spec;
    if (strncmp(spec, "constant:", 9) == 0) num = spec + 9;
    char* end = nullptr;
    long v = strtol(num, &end, 10);
    if (end == num || *end != '\0' || v < 0) return -1;
    mode = v == 0 ? kAdmOff : kAdmConstant;
    limit = (int)v;
  }
  {
    std::lock_guard g(g_adm_mu);
    g_min_latency_us = -1.0;
    g_window_start_ns = 0;
    g_window_count = 0;
    g_window_latency_sum_us = 0.0;
    g_probe_countdown = 10;
  }
  g_adm_limit.store(limit, std::memory_order_relaxed);
  g_adm_mode.store(mode, std::memory_order_release);
  g_adm_inflight.store(0, std::memory_order_relaxed);
  overload_recompute_gate();
  return 0;
}

// Queue-deadline drop: requests older than `ms` when a Python worker
// would take them are rejected with ELIMIT instead. <= 0 disables.
int nat_rpc_server_queue_deadline_ms(int ms) {
  g_queue_deadline_ms.store(ms > 0 ? ms : 0, std::memory_order_relaxed);
  overload_recompute_gate();
  return 0;
}

// Observability/tests: current in-flight admitted work requests.
int nat_rpc_server_inflight(void) {
  return g_adm_inflight.load(std::memory_order_relaxed);
}

// Observability/tests: the effective limit (auto: the computed one);
// 0 = no limiter.
int nat_rpc_server_limit(void) {
  return g_adm_mode.load(std::memory_order_relaxed) == kAdmOff
             ? 0
             : g_adm_limit.load(std::memory_order_relaxed);
}

}  // extern "C"

}  // namespace brpc_tpu
