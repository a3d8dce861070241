// Shared-memory usercode lane — zero-copy descriptor-ring transport.
//
// kind-3/4 (HTTP / gRPC) py-lane requests fan out to N WORKER PROCESSES,
// so Python usercode scales past one interpreter's GIL (the reference's
// usercode-on-all-N-workers concurrency, server.h:59-285 +
// details/usercode_backup_pool.h:29-72). This file is the same-host leg
// of the registered-arena north star (docs/cn/rdma.md): payload bytes are
// written ONCE into a shared blob arena and read in place on the other
// side; only fixed 64-byte descriptors cross the rings.
//
//   parent (native runtime)                 worker processes (Python)
//   reactor threads serialize the          nat_shm_take_request(): pops a
//   request INTO the worker's blob   ──▶   descriptor, hands out VIEWS
//   arena + publish one descriptor         into the arena (no copy);
//   (lock-free slot claim, waiter-         nat_req_free releases the span
//   gated doorbell)
//   response drainer + scheduler     ◀──   nat_shm_respond_*: payload into
//   idle hooks pop descriptors,            the worker's resp arena + one
//   emit via the ordered reorder           descriptor; one doorbell per
//   windows (big payloads ride             burst (waiter-gated futex)
//   arena-backed IOBuf user blocks
//   straight into writev)
//
// Concurrency design (replaces the round-4 byte rings, which paid a
// robust-mutex lock, a double memcpy and a futex wake PER RECORD):
//
//   * per-worker descriptor rings — fixed 64B seq-numbered slots (the
//     Vyukov bounded-queue discipline): the producer side is serialized
//     by a PROCESS-LOCAL mutex (parent reactor threads for request
//     rings, the worker's own threads for its response ring), consumers
//     pop lock-free with a CAS on the dequeue cursor (the parent drains
//     response rings from both the drainer thread and scheduler idle
//     hooks). Nothing on the hot path takes a cross-process lock.
//   * per-ring blob arenas — ring allocators whose spans carry an
//     8-byte header (alloc_len | released bit). Producers claim at the
//     tail (wrap spans never straddle: a released filler pads to the
//     edge), consumers set the released bit when done — possibly out of
//     order (user-block emits) — and the producer lazily reclaims
//     released spans from the head on the next claim.
//   * batched doorbells — futex wakes are WAITER-GATED: the producer
//     bumps a doorbell counter per record but issues the futex syscall
//     only when the consumer has registered itself as parked, so a
//     draining consumer costs zero wakes and a parked one costs one
//     wake per burst.
//   * robust-mutex recovery FENCE (slow path only): each worker holds
//     its slot's PTHREAD_PROCESS_SHARED|ROBUST mutex for its lifetime.
//     A worker dying with SIGKILL surfaces as EOWNERDEAD on the
//     drainer's periodic trylock probe; recovery drains the dead
//     worker's published responses, scrubs both arenas, discards its
//     queued requests and reaps their in-flight entries immediately
//     (no 30s timeout wait), then frees the slot for a fresh worker.
#include <linux/futex.h>
#include <signal.h>
#include <stdlib.h>
#include <sys/prctl.h>
#include <pthread.h>
#include <sys/syscall.h>
#include <sys/stat.h>
#include <sys/mman.h>

#include "nat_desc_ring.h"
#include "nat_internal.h"

#if defined(__SANITIZE_THREAD__)
#include <sanitizer/tsan_interface.h>
#endif

namespace brpc_tpu {

namespace {

constexpr int kMaxWorkers = 8;
constexpr uint32_t kRingSlots = 1024;  // power of two
// responses at least this big ride arena-backed IOBuf user blocks into
// the socket writev instead of being copied out of the arena
constexpr size_t kUserBlockMin = 64u << 10;

// Descriptor-ring + blob-arena core: nat_desc_ring.h (the SAME code the
// dsched model harness explores under virtual threads). ShmRing binds
// the production geometry; the local helpers below bind the segment's
// arena size so call sites keep their old shapes.
using ShmRing = DescRingT<kRingSlots>;
using ShmCell = ShmRing::Cell;
using CellView = DescCellView;
static_assert(sizeof(ShmCell) == 64, "descriptor must be one cache line");

struct ShmWorkerHdr {
  std::atomic<uint32_t> state;  // 0 free, 1 active, 2 recovering
  std::atomic<int32_t> pid;
  std::atomic<uint32_t> req_doorbell;
  std::atomic<uint32_t> req_waiters;
  // lifetime fence: locked by the worker at attach, held until death —
  // EOWNERDEAD on the parent's trylock probe IS the death notification.
  // Cross-process robust mutex: cannot be a NatMutex.
  pthread_mutex_t fence;  // natcheck:rank(shm.fence, 15)
  char pad[64];
};

// segment = header + kMaxWorkers * (hdr + req ring + req arena +
//                                   resp ring + resp arena)
struct ShmSeg {
  uint64_t magic;
  uint32_t version;
  uint32_t nslots;
  uint64_t arena_bytes;  // per ring
  std::atomic<int32_t> attached;  // live attached workers
  std::atomic<int32_t> shutdown;
  // liveness heartbeat: stamped (CLOCK_MONOTONIC ms) by every worker
  // take-loop pass, so the parent can detect all-workers-dead and fall
  // back to the in-process lane instead of 503ing via the reaper
  std::atomic<int64_t> last_worker_poll_ms{0};
  // parent-side drain doorbell, shared by every response ring
  std::atomic<uint32_t> resp_doorbell;
  std::atomic<uint32_t> resp_waiters;
};

int64_t mono_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}
constexpr uint64_t kShmMagic = 0x62727063646C6EULL ^ 0x2ULL;  // v2 lane

// The one process-wide segment mapping. ATOMIC pointer: scheduler idle
// hooks, reactor offers and fabric takes read it with no rendezvous
// against a stop->start replace — the OLD mapping is deliberately
// leaked so a stale pointer value stays dereferenceable, but the
// pointer word itself must not be a plain-load/store race.
std::atomic<ShmSeg*> g_seg_ptr{nullptr};
inline ShmSeg* seg_now() { return g_seg_ptr.load(std::memory_order_acquire); }
size_t g_seg_total = 0;
bool g_seg_unlinked = false;
char g_seg_name[64];
// Heap-held (leaked when never disabled): a global std::thread whose
// destructor runs at exit() while still joinable calls std::terminate,
// and the drainer must anyway never touch destructed globals (the
// bench-exit crash class, BENCH_r05 rc 139).
std::thread* g_resp_drainer = nullptr;
std::atomic<bool> g_lane_enabled{false};
std::atomic<bool> g_drainer_stop{false};

// parent-local producer locks (one per worker request ring) + routing
// natcheck:leak(g_req_mu): leaked — exit order vs the drainer thread
NatMutex<kLockRankShmReq>* g_req_mu =
    new NatMutex<kLockRankShmReq>[kMaxWorkers];
std::atomic<uint32_t> g_rr{0};
// parent-local: outstanding arena-backed user blocks per slot (responses
// in flight through socket write queues) + a recovery epoch so a release
// that outlives a slot recovery cannot scribble on the recycled arena
std::atomic<int> g_user_spans[kMaxWorkers] = {};
std::atomic<uint32_t> g_slot_epoch[kMaxWorkers] = {};

// parent-side tensor-fabric lease accounting: outstanding receiver
// leases per PRODUCER slot (state 4) — recovery of a dead producer
// waits these out (bounded) before scrubbing its arena
std::atomic<int> g_fab_leases[kMaxWorkers] = {};

// worker-local identity + response-ring producer lock
int g_my_slot = -1;
// producer-local identity (tensor-fabric push role, state-4 slot): a
// peer process that attached with nat_shm_producer_attach owns this
// slot's REQUEST ring as its sole producer — its threads serialize on
// g_fab_mu (process-local, like every ring's producer lock)
int g_my_prod_slot = -1;
// natcheck:leak(g_fab_mu): leaked — exit order vs pushing threads
NatMutex<kLockRankShmFabric>* g_fab_mu =
    new NatMutex<kLockRankShmFabric>;
// worker-local: when THIS thread's latest take_request popped its record
// (the sequential take -> handle -> respond worker loop's handling-start
// anchor); nat_shm_respond ships it back so the parent can stitch the
// worker span without any cross-process span ring.
thread_local uint64_t tls_take_ns = 0;
// natcheck:leak(g_resp_mu): leaked — exit order vs the worker loop
NatMutex<kLockRankShmResp>* g_resp_mu =
    new NatMutex<kLockRankShmResp>;

// every sub-block is 64-byte aligned: the segment base is page-aligned,
// the header/rings round up to 64, and arena_bytes is page-rounded.
//
// The *_of(s, ...) forms compute every address from ONE ShmSeg snapshot:
// a thread racing a stop->start segment replace must never mix the old
// mapping's base with the new mapping's arena_bytes (a wholly-stale
// pointer lands in the leaked-but-mapped old segment and is harmless; a
// MIXED computation is a wild pointer). The snapshot-less wrappers are
// for call sites that take their own snapshot or run on paths where the
// segment cannot be replaced concurrently.
size_t whdr_bytes() { return (sizeof(ShmWorkerHdr) + 63) & ~(size_t)63; }
size_t worker_block_bytes_of(const ShmSeg* s) {
  return whdr_bytes() + 2 * (sizeof(ShmRing) + (size_t)s->arena_bytes);
}
char* worker_base_of(ShmSeg* s, int i) {
  return (char*)s + ((sizeof(ShmSeg) + 63) & ~(size_t)63) +
         (size_t)i * worker_block_bytes_of(s);
}
ShmWorkerHdr* whdr_of(ShmSeg* s, int i) {
  return (ShmWorkerHdr*)worker_base_of(s, i);
}
ShmRing* wreq_of(ShmSeg* s, int i) {
  return (ShmRing*)(worker_base_of(s, i) + whdr_bytes());
}
char* req_arena_of(ShmSeg* s, int i) {
  return (char*)wreq_of(s, i) + sizeof(ShmRing);
}
ShmRing* wresp_of(ShmSeg* s, int i) {
  return (ShmRing*)(req_arena_of(s, i) + (size_t)s->arena_bytes);
}
char* resp_arena_of(ShmSeg* s, int i) {
  return (char*)wresp_of(s, i) + sizeof(ShmRing);
}
size_t worker_block_bytes() { return worker_block_bytes_of(seg_now()); }
char* worker_base(int i) { return worker_base_of(seg_now(), i); }
ShmWorkerHdr* whdr(int i) { return whdr_of(seg_now(), i); }
ShmRing* wreq(int i) { return wreq_of(seg_now(), i); }
char* req_arena(int i) { return req_arena_of(seg_now(), i); }
ShmRing* wresp(int i) { return wresp_of(seg_now(), i); }
char* resp_arena(int i) { return resp_arena_of(seg_now(), i); }

// Shared (non-PRIVATE) futex wait/wake on a doorbell counter.
//
// TSan note: the raw SYS_futex syscall is invisible to ThreadSanitizer
// (no interceptor), so the kernel-provided waker->waiter ordering of the
// SLEPT path must be annotated by hand. The awake paths are already
// ordered by the seq_cst doorbell atomics, but a consumer woken here —
// the response drainer and the scheduler idle-hook drain added in PR 3
// run this on fibers/threads the PR-2 fiber annotations predate — would
// otherwise race the producer's publish in TSan's model.
void futex_wait_shared(std::atomic<uint32_t>* a, uint32_t expect,
                       int timeout_ms) {
  struct timespec ts;
  ts.tv_sec = timeout_ms / 1000;
  ts.tv_nsec = (long)(timeout_ms % 1000) * 1000000L;
  syscall(SYS_futex, (uint32_t*)a, FUTEX_WAIT, expect, &ts, nullptr, 0);
#if defined(__SANITIZE_THREAD__)
  __tsan_acquire((void*)a);  // pairs with the waker's __tsan_release
#endif
}
void futex_wake_shared(std::atomic<uint32_t>* a) {
  // natfault doorbell site: a dropped wake verifies the waiter-gated
  // protocol degrades to bounded-timeout polls (200ms waits
  // everywhere), never to a lost record or a wedged consumer. A drop
  // IS the delay fault here (the consumer wakes on its poll timeout);
  // an inline sleep is not allowed — wake paths may hold producer locks.
  NatFaultAct fda = NAT_FAULT_POINT(NF_DOORBELL);
  if (fda.action == NF_DROP || fda.action == NF_DELAY) return;
#if defined(__SANITIZE_THREAD__)
  __tsan_release((void*)a);  // everything published is visible to wakees
#endif
  syscall(SYS_futex, (uint32_t*)a, FUTEX_WAKE, INT32_MAX, nullptr, nullptr,
          0);
}

// ---------------------------------------------------------------------------
// ring/arena wrappers binding seg_now()->arena_bytes (core: nat_desc_ring.h)
// ---------------------------------------------------------------------------

char* span_payload(char* arena, uint64_t span_off) {
  return desc_span_payload(arena, span_off, seg_now()->arena_bytes);
}

void span_release(char* arena, uint64_t span_off) {
  desc_span_release(arena, span_off, seg_now()->arena_bytes);
}

void ring_init(ShmRing* r) { desc_ring_init(r); }

bool ring_begin_push(ShmRing* r, char* arena, size_t len, uint64_t* pos_out,
                     uint64_t* span_out, char** dst) {
  return desc_ring_begin_push(r, arena, len, seg_now()->arena_bytes, pos_out,
                              span_out, dst);
}

void ring_publish(ShmRing* r, uint64_t pos, uint8_t kind, uint8_t flags,
                  uint64_t sock_id, int64_t cid, int32_t status,
                  uint64_t span, uint32_t payload_len, uint64_t aux) {
  desc_ring_publish(r, pos, kind, flags, sock_id, cid, status, span,
                    payload_len, aux);
}

bool ring_pop(ShmRing* r, CellView* out) { return desc_ring_pop(r, out); }

bool ring_has_data(ShmRing* r) { return desc_ring_has_data(r); }

void put_u32(char*& p, uint32_t v) {
  memcpy(p, &v, 4);
  p += 4;
}
void put_blob(char*& p, const char* d, size_t n) {
  put_u32(p, (uint32_t)n);
  if (n != 0) memcpy(p, d, n);
  p += n;
}
bool get_blob(const char*& p, const char* end, const char** d, size_t* n) {
  if (end - p < 4) return false;
  uint32_t len;
  memcpy(&len, p, 4);
  p += 4;
  if ((size_t)(end - p) < len) return false;
  *d = p;
  *n = len;
  p += len;
  return true;
}

// ---------------------------------------------------------------------------
// in-flight table (reaper): every request handed to the rings is tracked
// until a worker answers it, so a worker dying mid-request can never
// wedge a pipelined connection's reorder window (the drainer only emits
// responses whose entry is still present — a straggler answering after
// the reaper cannot double-respond).
// ---------------------------------------------------------------------------

struct InflightKey {
  uint64_t sock_id;
  int64_t seq;
  bool operator<(const InflightKey& o) const {
    return sock_id != o.sock_id ? sock_id < o.sock_id : seq < o.seq;
  }
};
struct InflightEntry {
  uint8_t kind;
  int8_t slot;  // worker the request was routed to (crash fast-reap)
  std::chrono::steady_clock::time_point deadline;
  // admission accounting (nat_overload.cpp): the in-flight token moves
  // from the PyRequest onto this entry when the request rides the rings
  // (shm_lane_offer), and is released exactly once at whichever erase
  // site retires the entry (response emit, reap, crash fast-reap).
  bool admitted = false;
  uint64_t enqueue_ns = 0;
  // rpcz span state (sampled at offer time): the PARENT records the
  // server span when the worker's response is emitted, and stitches the
  // worker-process span under it from the timing blob the response
  // record carries — find_trace then shows the full client -> native
  // server -> shm worker chain with no cross-process span ring.
  bool span_sampled = false;
  uint64_t trace_id = 0;        // incoming (or freshly started) trace
  uint64_t parent_span_id = 0;  // the CLIENT's span id off the wire
  uint64_t span_id = 0;         // this request's server span id
  uint64_t offer_ns = 0;        // request entered the worker rings
  char method[40] = {0};
  // per-method stats slot (nat_method_idx at offer time): concurrency
  // is held from offer to whichever erase site retires the entry
  int16_t method_stat = -1;
};

// Release an erased entry's admission token (call with g_inflight_mu
// NOT held; the limiter window has its own lock).
void inflight_entry_complete(const InflightEntry& e, bool ok) {
  if (!e.admitted) return;
  NAT_REF_RELEASED(nat_ref_adm_anchor(), adm.inflight);
  admission_on_complete(
      ok && e.enqueue_ns != 0 ? nat_now_ns() - e.enqueue_ns : 0, ok);
}
NatMutex<kLockRankShmInflight> g_inflight_mu;
// natcheck:leak(g_inflight): the reaper/drainer may outrun static
// destruction at exit()
std::map<InflightKey, InflightEntry>& g_inflight =
    *new std::map<InflightKey, InflightEntry>();
std::atomic<int> g_reap_timeout_ms{30000};

// Emit the error response that unwedges a reaped request's window slot.
void emit_reaped(uint8_t kind, uint64_t sock_id, int64_t seq) {
  if (kind == 3) {
    static const char kResp[] =
        "HTTP/1.1 503 Service Unavailable\r\nContent-Length: 24\r\n\r\n"
        "usercode worker timeout\n";
    nat_http_respond(sock_id, seq, kResp, sizeof(kResp) - 1, 0);
  } else {
    nat_grpc_respond(sock_id, seq, nullptr, 0, 14 /* UNAVAILABLE */,
                     "usercode worker timeout");
  }
}

void reap_expired() {
  auto now = std::chrono::steady_clock::now();
  std::vector<std::pair<InflightKey, InflightEntry>> dead;
  {
    std::lock_guard g(g_inflight_mu);
    for (auto it = g_inflight.begin(); it != g_inflight.end();) {
      if (it->second.deadline <= now) {
        dead.emplace_back(it->first, it->second);
        it = g_inflight.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (auto& d : dead) {
    emit_reaped(d.second.kind, d.first.sock_id, d.first.seq);
    inflight_entry_complete(d.second, /*ok=*/false);
    uint64_t rn = nat_now_ns();
    nat_method_end(d.second.method_stat,
                   d.second.offer_ns != 0 && rn > d.second.offer_ns
                       ? rn - d.second.offer_ns
                       : 0,
                   /*error=*/true);
  }
}

// Reap every in-flight request routed to `slot` NOW (its worker is dead:
// no answer is coming — waiting out the 30s timeout just serves 503s
// slower).
void reap_slot_inflight(int slot) {
  std::vector<std::pair<InflightKey, InflightEntry>> dead;
  {
    std::lock_guard g(g_inflight_mu);
    for (auto it = g_inflight.begin(); it != g_inflight.end();) {
      if (it->second.slot == slot) {
        dead.emplace_back(it->first, it->second);
        it = g_inflight.erase(it);
      } else {
        ++it;
      }
    }
  }
  for (auto& d : dead) {
    emit_reaped(d.second.kind, d.first.sock_id, d.first.seq);
    inflight_entry_complete(d.second, /*ok=*/false);
    uint64_t rn = nat_now_ns();
    nat_method_end(d.second.method_stat,
                   d.second.offer_ns != 0 && rn > d.second.offer_ns
                       ? rn - d.second.offer_ns
                       : 0,
                   /*error=*/true);
  }
}

// ---------------------------------------------------------------------------
// parent: response drain (drainer thread + scheduler idle hooks)
// ---------------------------------------------------------------------------

struct UserSpanCtx {
  int slot;
  uint32_t epoch;
  uint64_t span_off;
};

void user_span_free(void* raw) {
  UserSpanCtx* ctx = (UserSpanCtx*)raw;
  // a release outliving a slot recovery (epoch bump) must not scribble
  // the released bit onto arena bytes a fresh worker now owns. ONE
  // segment snapshot: this path runs with no rendezvous against a
  // stop->start replace — mixing the old base with the new arena_bytes
  // would compute a wild pointer (a wholly-stale one is harmless).
  ShmSeg* s = seg_now();
  if (s != nullptr &&
      g_slot_epoch[ctx->slot].load(std::memory_order_acquire) ==
          ctx->epoch) {
    desc_span_release(resp_arena_of(s, ctx->slot), ctx->span_off,
                      s->arena_bytes);
  }
  g_user_spans[ctx->slot].fetch_sub(1, std::memory_order_acq_rel);
  NAT_RES_FREE(NR_SHM_SEG, sizeof(UserSpanCtx), ctx);
  delete ctx;
}

// A descriptor's span/length must stay inside the arena (spans never
// straddle the edge by construction): a corrupt cell — a buggy worker
// scribbling shared memory — must be DROPPED, never chased into a read
// past the mapping (the parent-crash class the old byte rings validated
// against).
// natcheck:wire: c — descriptor cell fields read from shared memory
bool span_sane(const CellView& c) {
  uint64_t asize = seg_now()->arena_bytes;
  uint64_t off = c.span_off % asize;
  return (off & 63) == 0 && (uint64_t)c.payload_len <= asize &&
         off + 8 + (uint64_t)c.payload_len <= asize;
}

// Emit one popped response descriptor through the ordered emitters.
void emit_response(int slot, const CellView& c) {
  if (!span_sane(c)) return;  // corrupt cell: drop (reaper answers it)
  char* arena = resp_arena(slot);
  const char* p = span_payload(arena, c.span_off);
  const char* end = p + c.payload_len;
  const char *payload = nullptr, *message = nullptr;
  size_t payload_len = 0, message_len = 0;
  if (!get_blob(p, end, &payload, &payload_len) ||
      !get_blob(p, end, &message, &message_len)) {
    span_release(arena, c.span_off);
    return;  // corrupt record: drop (reaper answers the request)
  }
  // optional worker-timing blob (16B: take_ns, respond_ns) appended by
  // nat_shm_respond — CLOCK_MONOTONIC is machine-wide, so the worker
  // process's timestamps are directly comparable with the parent's
  uint64_t wk_take_ns = 0, wk_resp_ns = 0;
  {
    const char* tb = nullptr;
    size_t tb_len = 0;
    if (get_blob(p, end, &tb, &tb_len) && tb_len == 16) {
      memcpy(&wk_take_ns, tb, 8);
      memcpy(&wk_resp_ns, tb + 8, 8);
    }
  }
  InflightEntry done_entry;
  {
    // already reaped (worker answered late): drop — emitting twice
    // would poison the session reorder windows
    std::lock_guard g(g_inflight_mu);
    auto it = g_inflight.find(InflightKey{c.sock_id, c.cid});
    if (it == g_inflight.end()) {
      span_release(arena, c.span_off);
      return;
    }
    done_entry = it->second;
    g_inflight.erase(it);
  }
  // errored worker responses must not feed the gradient limiter's
  // capacity window (the in-process lane's admit_ok filter, mirrored):
  // gRPC status rides the descriptor; HTTP status is the serialized
  // head's first digit ("HTTP/1.1 5xx")
  bool resp_ok = !(c.kind == 4 && c.status != 0) &&
                 !(c.kind == 3 && payload_len >= 10 && payload[9] == '5');
  inflight_entry_complete(done_entry, resp_ok);
  if (wk_take_ns != 0 && wk_resp_ns >= wk_take_ns) {
    nat_lat_record(NL_WORKER, wk_resp_ns - wk_take_ns);
  }
  {
    // per-method completion: offer -> emit covers queueing + usercode
    uint64_t now_ns = nat_now_ns();
    nat_method_end(done_entry.method_stat,
                   done_entry.offer_ns != 0 && now_ns > done_entry.offer_ns
                       ? now_ns - done_entry.offer_ns
                       : 0,
                   !resp_ok);
  }
  if (done_entry.span_sampled) {
    uint64_t now = nat_now_ns();
    size_t mn = strnlen(done_entry.method, sizeof(done_entry.method));
    // server span: request offered to the rings -> response emitted
    NatSpanRec rec;
    memset(&rec, 0, sizeof(rec));
    rec.trace_id = done_entry.trace_id;
    rec.span_id = done_entry.span_id;
    rec.parent_span_id = done_entry.parent_span_id;
    rec.sock_id = c.sock_id;
    rec.recv_ns = done_entry.offer_ns;
    rec.parse_ns = done_entry.offer_ns;
    rec.dispatch_ns = wk_resp_ns != 0 ? wk_resp_ns : now;
    rec.write_ns = now;
    rec.protocol = c.kind == 4 ? NL_GRPC : NL_HTTP;
    rec.error_code = resp_ok ? 0 : (c.kind == 4 ? c.status : 503);
    rec.resp_bytes = (uint32_t)payload_len;
    memcpy(rec.method, done_entry.method, mn);
    rec.method[mn] = '\0';
    nat_span_submit(rec);
    // worker span: the usercode leg inside the worker process, chained
    // under the server span (take -> respond, worker-stamped clocks)
    if (wk_take_ns != 0) {
      NatSpanRec wrec;
      memset(&wrec, 0, sizeof(wrec));
      wrec.trace_id = done_entry.trace_id;
      wrec.span_id = nat_span_id63();
      wrec.parent_span_id = done_entry.span_id;
      wrec.sock_id = (uint64_t)slot;
      wrec.recv_ns = wk_take_ns;
      wrec.parse_ns = wk_take_ns;
      wrec.dispatch_ns = wk_resp_ns;
      wrec.write_ns = wk_resp_ns;
      wrec.protocol = NL_WORKER;
      wrec.error_code = resp_ok ? 0 : -1;
      wrec.resp_bytes = (uint32_t)payload_len;
      memcpy(wrec.method, done_entry.method, mn);
      wrec.method[mn] = '\0';
      nat_span_submit(wrec);
    }
  }
  if (c.kind == 3 && payload_len >= kUserBlockMin) {
    // zero-copy emit: the response IOBuf references the arena span via a
    // user block; the span releases when the socket writev consumed it
    UserSpanCtx* ctx = new UserSpanCtx{
        slot, g_slot_epoch[slot].load(std::memory_order_acquire),
        c.span_off};
    NAT_RES_ALLOC(NR_SHM_SEG, sizeof(UserSpanCtx), ctx);
    g_user_spans[slot].fetch_add(1, std::memory_order_acq_rel);
    IOBuf body;
    body.append_user(payload, payload_len, user_span_free, ctx);
    http_respond_iobuf(c.sock_id, c.cid, std::move(body),
                       (c.flags & 1) != 0);
    return;
  }
  if (c.kind == 3) {
    nat_http_respond(c.sock_id, c.cid, payload, payload_len,
                     (c.flags & 1) != 0);
  } else if (c.kind == 4) {
    char mbuf[256];
    const char* msg = nullptr;
    if (message_len != 0) {
      size_t n = message_len < sizeof(mbuf) - 1 ? message_len
                                                : sizeof(mbuf) - 1;
      memcpy(mbuf, message, n);
      mbuf[n] = '\0';
      msg = mbuf;
    }
    nat_grpc_respond(c.sock_id, c.cid, payload, payload_len, c.status, msg);
  }
  span_release(arena, c.span_off);
}

// Per-slot consumer handshake with recovery: a consumer marks itself
// busy, then RE-CHECKS the slot state before popping; recovery flips the
// state to 2 first and then waits for busy to clear — so either the
// consumer backs off, or recovery waits out its in-flight emit (which
// includes the user-span bookkeeping a mid-emit pop would otherwise
// register after recovery's quiesce check).
std::atomic<int> g_emit_busy[kMaxWorkers] = {};

// One sweep over every ACTIVE response ring; true when anything drained.
// (state==2 slots are recovery-owned: recover_slot drains them itself.)
bool drain_resp_once() {
  if (seg_now() == nullptr) return false;
  bool any = false;
  for (int i = 0; i < kMaxWorkers; i++) {
    if (whdr(i)->state.load(std::memory_order_seq_cst) != 1) continue;
    g_emit_busy[i].fetch_add(1, std::memory_order_seq_cst);
    if (whdr(i)->state.load(std::memory_order_seq_cst) == 1) {
      CellView c;
      while (ring_pop(wresp(i), &c)) {
        any = true;
        emit_response(i, c);
      }
    }
    g_emit_busy[i].fetch_sub(1, std::memory_order_seq_cst);
  }
  return any;
}

bool resp_any_ready() {
  for (int i = 0; i < kMaxWorkers; i++) {
    if (whdr(i)->state.load(std::memory_order_acquire) != 0 &&
        ring_has_data(wresp(i))) {
      return true;
    }
  }
  return false;
}

// ---------------------------------------------------------------------------
// recovery (the robust-fence slow path)
// ---------------------------------------------------------------------------

// Scrub every span header in [head, tail): after the slot's responses
// are drained and in-flight user blocks released, anything unreleased is
// the dead worker's half-claimed garbage.
void scrub_arena(ShmRing* r, char* arena) {
  desc_scrub_arena(r, arena, seg_now()->arena_bytes);
}

void ring_discard_claims(ShmRing* r) { desc_ring_discard_claims(r); }

// Recover a dead worker's slot. Requires the fence (EOWNERDEAD, made
// consistent) to be held by the caller.
void recover_slot(int i) {
  ShmWorkerHdr* w = whdr(i);
  w->state.store(2, std::memory_order_seq_cst);  // offers/drains back off
  // wait out consumers already mid-drain on this slot (drainer thread /
  // idle hooks): after busy clears, every pop's user-span bookkeeping is
  // registered, so the quiesce wait below sees the true count.
  // natcheck:allow(lock-switch): recovery slow path on the drainer
  // thread (never a fiber); the probe lock is deliberately held so a
  // second prober cannot race this quiesce
  while (g_emit_busy[i].load(std::memory_order_seq_cst) > 0) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  bool spans_quiesced;
  {
    std::lock_guard g(g_req_mu[i]);  // flush in-flight offers
    // late responses the dead worker DID publish are still valid: emit
    CellView c;
    while (ring_pop(wresp(i), &c)) emit_response(i, c);
    // a worker killed between claim and publish leaves the response ring
    // wedged on an unpublished cell: free the claimed range (anything
    // published-but-unreachable behind it is lost — its request 503s)
    ring_discard_claims(wresp(i));
    // wait (bounded) for arena-backed user blocks still riding socket
    // write queues; the epoch bump below fences any straggler
    auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(5);
    // natcheck:allow(lock-switch): bounded recovery wait; g_req_mu is
    // held ON PURPOSE — it fences mid-flight offers out of the slot
    // being scrubbed (drainer thread only, never a fiber)
    while (g_user_spans[i].load(std::memory_order_acquire) > 0 &&
           std::chrono::steady_clock::now() < deadline) {
      // natcheck:allow(lock-switch): see the comment above this loop
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
    }
    spans_quiesced = g_user_spans[i].load(std::memory_order_acquire) == 0;
    g_slot_epoch[i].fetch_add(1, std::memory_order_acq_rel);
    // discard queued requests the worker never took
    ShmRing* rq = wreq(i);
    ring_discard_claims(rq);
    scrub_arena(rq, req_arena(i));
    if (spans_quiesced) {
      scrub_arena(wresp(i), resp_arena(i));
    }
    // else: a response is STILL queued on some glacial socket past the
    // deadline — leak the unreleased spans (the epoch bump stops the
    // eventual release from touching them) rather than hand bytes a
    // live writev still reads to the replacement worker
  }
  // answer everything that was routed to this worker NOW
  reap_slot_inflight(i);
  seg_now()->attached.fetch_sub(1, std::memory_order_acq_rel);
  w->pid.store(0, std::memory_order_relaxed);
  w->state.store(0, std::memory_order_seq_cst);  // slot reusable
}

// Recover a dead PRODUCER slot (tensor fabric, state 4). Requires the
// fence (EOWNERDEAD, made consistent) to be held by the caller. Records
// the dead producer published but nobody took are DISCARDED (the sender
// died; its RPCs fail with it); receiver-held leases are waited out
// (bounded) before the arena scrub, and the epoch bump fences any
// straggler lease release off the recycled arena.
void recover_producer_slot(int i) {
  ShmWorkerHdr* w = whdr(i);
  w->state.store(2, std::memory_order_seq_cst);  // takes back off
  // wait out fabric takes already mid-pop on this slot: after busy
  // clears, every taken record's lease is registered in g_fab_leases
  // natcheck:allow(lock-switch): recovery slow path on the drainer
  // thread (never a fiber); the probe lock is held by the caller
  while (g_emit_busy[i].load(std::memory_order_seq_cst) > 0) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  {
    CellView c;
    while (ring_pop(wreq(i), &c)) {
      if (span_sane(c)) span_release(req_arena(i), c.span_off);
      nat_counter_add(NS_FABRIC_RECOVER_DROPS, 1);
    }
    ring_discard_claims(wreq(i));
  }
  auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(5);
  // natcheck:allow(lock-switch): bounded recovery wait (drainer thread
  // only, never a fiber) — receiver leases drain on their own schedule
  while (g_fab_leases[i].load(std::memory_order_acquire) > 0 &&
         std::chrono::steady_clock::now() < deadline) {
    // natcheck:allow(lock-switch): see the comment above this loop
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  bool quiesced = g_fab_leases[i].load(std::memory_order_acquire) == 0;
  g_slot_epoch[i].fetch_add(1, std::memory_order_acq_rel);
  g_fab_leases[i].store(0, std::memory_order_release);
  if (quiesced) {
    scrub_arena(wreq(i), req_arena(i));
  }
  // else: a lease is STILL held past the deadline — leak its span (the
  // epoch bump stops the eventual release from touching the arena)
  // rather than hand bytes a live reader still maps to a new producer
  w->pid.store(0, std::memory_order_relaxed);
  w->state.store(0, std::memory_order_seq_cst);  // slot reusable
}

// Probe every active slot's lifetime fence; recover the dead. Returns
// the number of slots recovered. Parent-side only (drainer thread or an
// explicit nat_shm_lane_recover_probe call); g_probe_mu serializes the
// two against each other.
NatMutex<kLockRankShmProbe> g_probe_mu;
int probe_fences() {
  if (seg_now() == nullptr) return 0;
  std::lock_guard pg(g_probe_mu);
  int recovered = 0;
  for (int i = 0; i < kMaxWorkers; i++) {
    ShmWorkerHdr* w = whdr(i);
    uint32_t st = w->state.load(std::memory_order_acquire);
    if (st != 1 && st != 4) continue;
    if (i == g_my_prod_slot) continue;  // our own producer role: alive
    int rc = pthread_mutex_trylock(&w->fence);
    if (rc == EBUSY) continue;  // worker/producer alive, holding its fence
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&w->fence);
    if (rc == EOWNERDEAD || rc == 0) {
      // rc == 0 (unlocked while active) is the same condition: a live
      // worker holds its fence for its whole lifetime.
      if (st == 4) {
        // natcheck:allow(lock-switch): recovery quiesce sleeps under
        // the probe lock + fence by design (see recover_producer_slot)
        recover_producer_slot(i);
      } else {
        // natcheck:allow(lock-switch): recovery quiesce sleeps under
        // the probe lock + fence by design (see recover_slot)
        recover_slot(i);
      }
      recovered++;
    }
    if (rc == EOWNERDEAD || rc == 0) pthread_mutex_unlock(&w->fence);
  }
  return recovered;
}

// parent: response records -> the ordered per-session emitters
void resp_drainer_loop() {
  while (!g_drainer_stop.load(std::memory_order_relaxed)) {
    bool any = drain_resp_once();
    reap_expired();
    probe_fences();
    if (!any) {
      // waiter-gated park: producers only pay the futex wake while this
      // flag is up (one wake per burst, not per record)
      uint32_t db = seg_now()->resp_doorbell.load(std::memory_order_seq_cst);
      seg_now()->resp_waiters.fetch_add(1, std::memory_order_seq_cst);
      if (!resp_any_ready() &&
          !g_drainer_stop.load(std::memory_order_relaxed)) {
        futex_wait_shared(&seg_now()->resp_doorbell, db, 200);
      }
      seg_now()->resp_waiters.fetch_sub(1, std::memory_order_seq_cst);
    }
  }
}

// scheduler idle hook: parked fiber workers drain response rings instead
// of sleeping — the doorbell's fast path on a busy host
bool shm_idle_drain() {
  if (!g_lane_enabled.load(std::memory_order_acquire)) return false;
  return drain_resp_once();
}

// serialize a kind-3/4 request record into `dst`
size_t request_blob_bytes(const PyRequest* r) {
  return 16 + r->service.size() + r->method.size() + r->meta_bytes.size() +
         r->payload.size();
}
void serialize_request(char* dst, const PyRequest* r) {
  char* p = dst;
  put_blob(p, r->service.data(), r->service.size());
  put_blob(p, r->method.data(), r->method.size());
  put_blob(p, r->meta_bytes.data(), r->meta_bytes.size());
  put_blob(p, r->payload.data(), r->payload.size());
}

// Route one record to some live worker: claim, serialize and publish
// under the per-worker producer lock (recovery takes the same lock, so
// a slot can never be scrubbed with an offer mid-flight — a late
// publish/memcpy would otherwise land on cells/spans the replacement
// worker already owns), then ring the doorbell (waiter-gated) outside
// it. Contended workers are skipped via try_lock, so holding the lock
// across the memcpy spreads load instead of convoying producers.
// fill(dst) writes exactly `blob_len` bytes.
template <typename Fill>
bool push_to_some_worker(uint8_t kind, uint8_t flags, uint64_t sock_id,
                         int64_t cid, int32_t status, size_t blob_len,
                         uint64_t aux, const Fill& fill, int* slot_out) {
  uint32_t start = g_rr.fetch_add(1, std::memory_order_relaxed);
  for (int k = 0; k < kMaxWorkers; k++) {
    int i = (int)((start + (uint32_t)k) % kMaxWorkers);
    ShmWorkerHdr* w = whdr(i);
    if (w->state.load(std::memory_order_seq_cst) != 1) continue;
    {
      std::unique_lock lk(g_req_mu[i], std::try_to_lock);
      if (!lk.owns_lock()) continue;  // contended: spread to the next
      if (w->state.load(std::memory_order_seq_cst) != 1) continue;
      uint64_t pos, span;
      char* dst;
      if (!ring_begin_push(wreq(i), req_arena(i), blob_len, &pos, &span,
                           &dst)) {
        continue;  // ring/arena full: try the next worker (backpressure)
      }
      fill(dst);
      ring_publish(wreq(i), pos, kind, flags, sock_id, cid, status, span,
                   (uint32_t)blob_len, aux);
    }
    w->req_doorbell.fetch_add(1, std::memory_order_seq_cst);
    if (w->req_waiters.load(std::memory_order_seq_cst) != 0) {
      futex_wake_shared(&w->req_doorbell);
    }
    if (slot_out != nullptr) *slot_out = i;
    return true;
  }
  return false;
}

}  // namespace

// Quiesce drain predicate (nat_quiesce.cpp): nothing riding the worker
// rings right now — every offered request was answered or reaped.
bool shm_lane_inflight_empty() {
  std::lock_guard g(g_inflight_mu);
  return g_inflight.empty();
}

// release hook for arena-backed PyRequests (declared in nat_internal.h,
// called from ~PyRequest in whichever process owns the request).
// Releases may land OUT OF ORDER relative to takes — the arena's
// released-bit + lazy head reclaim is built for exactly that — so a
// consumer can hold a record's span (a LEASE) across further drains.
void shm_req_span_release(PyRequest* r) {
  // ONE segment snapshot for the whole release: this path runs with no
  // rendezvous against a stop->start replace (see user_span_free).
  ShmSeg* s = seg_now();
  if (s == nullptr || r->shm_slot < 0 || r->shm_slot >= kMaxWorkers) {
    return;
  }
  // ledger retire is unconditional and symmetric with the take-side
  // NAT_RES_ALLOC (every shm-slot request was accounted at its take,
  // including zero-length records — a bytes!=0 guard here would leak
  // live_objects forever on empty tensors)
  NAT_RES_FREE(NR_SHM_SPAN, r->shm_span_bytes, r);
  if (r->shm_lease) {
    // receiver-side fabric lease: the producer slot may have been
    // recovered (producer SIGKILL -> epoch bump) while this lease was
    // held — a stale release must not scribble the released bit onto
    // arena bytes a fresh producer now owns
    NAT_REF_RELEASED(r, shm.lease);
    if (g_slot_epoch[r->shm_slot].load(std::memory_order_acquire) ==
        r->shm_epoch) {
      desc_span_release(req_arena_of(s, r->shm_slot), r->shm_span,
                        s->arena_bytes);
      g_fab_leases[r->shm_slot].fetch_sub(1, std::memory_order_acq_rel);
    }
    // stale epoch: the slot was recovered with this lease outstanding —
    // its count was zeroed there, so only current-epoch leases decrement
    return;
  }
  NAT_REF_RELEASED(r, shm.span);
  desc_span_release(req_arena_of(s, r->shm_slot), r->shm_span,
                    s->arena_bytes);
}

// enqueue hook used by the cut loops: true = the request was routed to
// the shm worker lane (consumed), false = keep the in-process py lane.
bool shm_lane_offer(PyRequest* r) {
  if (!g_lane_enabled.load(std::memory_order_acquire)) return false;
  if (r->kind != 3 && r->kind != 4) return false;
  // all workers dead/stalled (no take-loop heartbeat for 2s): serve
  // in-process instead of queueing requests for the reaper to 503
  int64_t last = seg_now()->last_worker_poll_ms.load(std::memory_order_relaxed);
  if (last == 0 || mono_ms() - last > 2000) return false;
  size_t blob_len = request_blob_bytes(r);
  // track BEFORE the publish: once the descriptor is visible a worker
  // may answer instantly, and the drainer drops responses with no entry
  InflightEntry entry;
  entry.kind = (uint8_t)r->kind;
  entry.slot = -1;
  entry.deadline = std::chrono::steady_clock::now() +
                   std::chrono::milliseconds(
                       g_reap_timeout_ms.load(std::memory_order_relaxed));
  // span sampling decided HERE (the wire parse's trace context rides the
  // PyRequest): the emit side records the server + worker spans when the
  // response comes back
  entry.offer_ns = nat_now_ns();
  {
    size_t mn = r->method.size() < sizeof(entry.method) - 1
                    ? r->method.size()
                    : sizeof(entry.method) - 1;
    memcpy(entry.method, r->method.data(), mn);
  }
  // per-method row (the worker-dispatched half of the native
  // MethodStatus table): concurrency spans offer -> emit/reap
  entry.method_stat = (int16_t)nat_method_idx(
      r->kind == 4 ? NL_GRPC : NL_HTTP, entry.method,
      strnlen(entry.method, sizeof(entry.method)));
  nat_method_begin(entry.method_stat);
  if ((entry.span_sampled = nat_span_tick())) {
    entry.trace_id = r->trace_id != 0 ? r->trace_id : nat_span_id63();
    entry.parent_span_id = r->parent_span_id;
    entry.span_id = nat_span_id63();
  }
  {
    std::lock_guard g(g_inflight_mu);
    // admitted stays false until the push lands: the failure path below
    // erases this entry and the request continues on the in-process
    // lane, which still owns the admission token
    g_inflight[InflightKey{r->sock_id, r->cid}] = entry;
  }
  int slot = -1;
  bool ok = push_to_some_worker(
      (uint8_t)r->kind, 0, r->sock_id, r->cid, 0, blob_len, 0,
      [&](char* dst) { serialize_request(dst, r); }, &slot);
  if (!ok) {
    {
      std::lock_guard g(g_inflight_mu);
      g_inflight.erase(InflightKey{r->sock_id, r->cid});
    }
    // the call continues on the in-process lane: undo the concurrency
    // bracket (no completed call to record)
    nat_method_abort(entry.method_stat);
    return false;  // every ring full / no live worker: in-process lane
  }
  {
    std::lock_guard g(g_inflight_mu);
    auto it = g_inflight.find(InflightKey{r->sock_id, r->cid});
    if (it != g_inflight.end()) {
      it->second.slot = (int8_t)slot;
      // transfer the admission token onto the entry: the erase sites
      // (emit/reap) release it, not ~PyRequest
      it->second.admitted = r->admitted;
      it->second.enqueue_ns = r->enqueue_ns;
      if (r->admitted) {
        NAT_REF_TRANSFER(nat_ref_adm_anchor(), adm.pyreq, adm.inflight);
      }
      r->admitted = false;
    }
  }
  if (r->admitted) {
    // the worker answered (and the entry was erased) before the token
    // could transfer: release it here — exactly once either way
    r->admitted = false;
    NAT_REF_RELEASED(nat_ref_adm_anchor(), adm.pyreq);
    admission_on_complete(
        r->enqueue_ns != 0 ? nat_now_ns() - r->enqueue_ns : 0, true);
  }
  delete r;
  return true;
}

extern "C" {

// Parent: create the segment (call BEFORE spawning workers). Returns 0.
// After a full disable (which unlinks the name) a new segment with a
// fresh name is created, so stop -> start cycles work.
int nat_shm_lane_create(size_t ring_bytes) {
  if (seg_now() != nullptr && !g_seg_unlinked) return 0;
  if (seg_now() != nullptr) {  // previous lane fully shut down: replace
    // fence stragglers first: an arena-backed user block still riding a
    // socket write queue must not release its span into the NEW segment
    for (int i = 0; i < kMaxWorkers; i++) {
      g_slot_epoch[i].fetch_add(1, std::memory_order_acq_rel);
    }
    // LEAK the old mapping rather than munmap it: the scheduler idle
    // hook, a reactor mid-offer, or a late user-block release may still
    // be dereferencing the old pointers (only the lane-enabled flag
    // gates them, not a rendezvous) — a stray touch of an unlinked,
    // still-mapped segment is harmless, a touch of an unmapped one is a
    // SIGSEGV. Stop->start cycles are rare; the cost is bounded virtual
    // address space, not RAM that matters. The ledger keeps the old
    // mapping's bytes LIVE on purpose: leaked-but-resident pages are
    // exactly what the /status RSS reconciliation must attribute.
    g_seg_ptr.store(nullptr, std::memory_order_release);
    g_my_slot = -1;
    g_my_prod_slot = -1;
  }
  if (ring_bytes == 0) ring_bytes = 8u << 20;
  ring_bytes = (ring_bytes + 4095) & ~(size_t)4095;
  static std::atomic<int> counter{0};
  // The segment's prefix is this library's own: a process holding both
  // this library and brpc_tpu's would otherwise have each shm_unlink the
  // other's segment (same pid, same counter) before its O_EXCL open.
  snprintf(g_seg_name, sizeof(g_seg_name), "/brpc_tpu_torch_lane_%d_%d",
           (int)getpid(), counter.fetch_add(1, std::memory_order_relaxed));
  size_t block = ((sizeof(ShmWorkerHdr) + 63) & ~(size_t)63) +
                 2 * (sizeof(ShmRing) + ring_bytes);
  size_t total =
      ((sizeof(ShmSeg) + 63) & ~(size_t)63) + (size_t)kMaxWorkers * block;
  shm_unlink(g_seg_name);
  int fd = shm_open(g_seg_name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -1;
  if (ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    shm_unlink(g_seg_name);
    return -1;
  }
  void* mem =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(g_seg_name);
    return -1;
  }
  NAT_RES_ALLOC(NR_SHM_SEG, total, mem);
  g_seg_ptr.store((ShmSeg*)mem, std::memory_order_release);
  g_seg_total = total;
  g_seg_unlinked = false;
  seg_now()->magic = kShmMagic;
  seg_now()->version = 2;
  seg_now()->nslots = kMaxWorkers;
  seg_now()->arena_bytes = ring_bytes;
  seg_now()->attached.store(0, std::memory_order_relaxed);
  seg_now()->shutdown.store(0, std::memory_order_relaxed);
  seg_now()->last_worker_poll_ms.store(0, std::memory_order_relaxed);
  seg_now()->resp_doorbell.store(0, std::memory_order_relaxed);
  seg_now()->resp_waiters.store(0, std::memory_order_relaxed);
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  for (int i = 0; i < kMaxWorkers; i++) {
    ShmWorkerHdr* w = whdr(i);
    w->state.store(0, std::memory_order_relaxed);
    w->pid.store(0, std::memory_order_relaxed);
    w->req_doorbell.store(0, std::memory_order_relaxed);
    w->req_waiters.store(0, std::memory_order_relaxed);
    pthread_mutex_init(&w->fence, &ma);
    ring_init(wreq(i));
    ring_init(wresp(i));
    g_user_spans[i].store(0, std::memory_order_relaxed);
    g_fab_leases[i].store(0, std::memory_order_relaxed);
  }
  pthread_mutexattr_destroy(&ma);
  return 0;
}

// Worker-slot capacity of the lane (the per-worker rings/arenas are
// pre-carved at create): the Python mount clamps py_workers against
// this instead of hand-mirroring the constant.
int nat_shm_lane_max_workers() { return kMaxWorkers; }

// Parent: how many workers are attached and live (readiness barrier —
// a short reap timeout must not fire while workers are still booting).
int nat_shm_lane_workers() {
  return seg_now() != nullptr
             ? seg_now()->attached.load(std::memory_order_acquire)
             : 0;
}

const char* nat_shm_lane_name() { return seg_now() != nullptr ? g_seg_name : ""; }

// Parent: route kind-3/4 py-lane requests to the workers + start the
// response drainer and the scheduler idle-hook drain. Disable signals
// shutdown, stops the drainer and unlinks the shm name (the RAM-backed
// segment must not outlive the server run); the mapping stays until a
// later create replaces it.
int nat_shm_lane_enable(int enable) {
  if (seg_now() == nullptr) return -1;
  if (enable != 0 && !g_lane_enabled.load(std::memory_order_acquire)) {
    {
      std::lock_guard g(g_inflight_mu);
      // entries recorded nat_method_begin at offer time; dropping them
      // without the abort would pin per-method concurrency forever
      for (const auto& kv : g_inflight) {
        nat_method_abort(kv.second.method_stat);
      }
      g_inflight.clear();
    }
    seg_now()->shutdown.store(0, std::memory_order_release);
    g_drainer_stop.store(false, std::memory_order_relaxed);
    delete g_resp_drainer;
    // natcheck:allow(resacct): control-plane thread handle
    g_resp_drainer = new std::thread(resp_drainer_loop);
    static std::atomic<bool> hook_added{false};
    if (!hook_added.exchange(true, std::memory_order_acq_rel)) {
      Scheduler::instance()->add_idle_hook([] { return shm_idle_drain(); });
    }
    g_lane_enabled.store(true, std::memory_order_release);
  } else if (enable == 0) {
    g_lane_enabled.store(false, std::memory_order_release);
    seg_now()->shutdown.store(1, std::memory_order_release);
    g_drainer_stop.store(true, std::memory_order_relaxed);
    // wake every parked consumer so shutdown is observed promptly
    seg_now()->resp_doorbell.fetch_add(1, std::memory_order_seq_cst);
    futex_wake_shared(&seg_now()->resp_doorbell);
    for (int i = 0; i < kMaxWorkers; i++) {
      whdr(i)->req_doorbell.fetch_add(1, std::memory_order_seq_cst);
      futex_wake_shared(&whdr(i)->req_doorbell);
    }
    if (g_resp_drainer != nullptr && g_resp_drainer->joinable()) {
      g_resp_drainer->join();
    }
    // the drainer is gone, so nothing will ever retire entries still in
    // flight: release their method-concurrency slots and admission
    // tokens now instead of pinning them until a later re-enable
    std::vector<InflightEntry> orphans;
    {
      std::lock_guard g(g_inflight_mu);
      orphans.reserve(g_inflight.size());
      for (const auto& kv : g_inflight) {
        nat_method_abort(kv.second.method_stat);
        orphans.push_back(kv.second);
      }
      g_inflight.clear();
    }
    for (const auto& e : orphans) inflight_entry_complete(e, false);
    if (!g_seg_unlinked) {
      shm_unlink(g_seg_name);
      g_seg_unlinked = true;
    }
  }
  return 0;
}

// Test/ops knob: how long an unanswered worker request waits before the
// reaper answers it with 503/UNAVAILABLE (default 30s).
int nat_shm_lane_set_timeout_ms(int ms) {
  if (ms <= 0) return -1;
  g_reap_timeout_ms.store(ms, std::memory_order_relaxed);
  return 0;
}

// Ops/test entry: probe every worker fence once and recover dead slots
// (the drainer does this continuously while the lane is enabled).
// Returns the number of slots recovered.
int nat_shm_lane_recover_probe(void) { return probe_fences(); }

// Cross-process trust boundary: a segment image we are about to attach
// to was produced by ANOTHER process (or forged/corrupted on disk in
// /dev/shm) — every header field is wire data until proven consistent
// with the bytes actually mapped. Rejecting here means a malicious or
// corrupt peer segment fails the attach loudly instead of the layout
// helpers chasing nslots/arena_bytes into reads past the mapping
// (symmetric with span_sane()'s per-descriptor bounds check, PR 3).
static bool shm_seg_image_check(const void* mem, size_t len) {
  if (mem == nullptr || len < sizeof(ShmSeg)) return false;
  const ShmSeg* s = (const ShmSeg*)mem;
  if (s->magic != kShmMagic) return false;
  if (s->version != 2) return false;
  // natcheck:wire: nslots, arena_bytes — peer-written header fields
  uint32_t nslots = s->nslots;
  uint64_t arena_bytes = s->arena_bytes;
  // creation always carves exactly kMaxWorkers slots and a page-rounded
  // arena; anything else is not a segment this build produced
  if (nslots != (uint32_t)kMaxWorkers) return false;
  if (arena_bytes == 0 || (arena_bytes & 4095) != 0 ||
      arena_bytes > (1ull << 30)) {
    return false;
  }
  // the layout the header claims must fit the bytes actually mapped:
  // header + nslots * (worker hdr + 2 * (ring + arena))
  uint64_t block = (uint64_t)whdr_bytes() +
                   2 * ((uint64_t)sizeof(ShmRing) + arena_bytes);
  uint64_t total = ((sizeof(ShmSeg) + 63) & ~(uint64_t)63) +
                   (uint64_t)nslots * block;
  return total <= (uint64_t)len;
}

// Fuzz/ops seam: validate a candidate segment image without mapping or
// attaching — drives shm_seg_image_check over arbitrary bytes.
int nat_shm_seg_validate(const void* mem, size_t len) {
  return shm_seg_image_check(mem, len) ? 1 : 0;
}

// Worker: map the parent's segment (same-process callers reuse the
// existing mapping) and claim a worker slot by locking its lifetime
// fence. Also arms parent-death delivery of SIGTERM so a hard parent
// crash cannot leave orphan workers polling the (leaked) segment.
int nat_shm_worker_attach(const char* name) {
  if (g_my_slot >= 0) return 0;
  if (seg_now() == nullptr) {
    prctl(PR_SET_PDEATHSIG, SIGTERM);
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      return -1;
    }
    void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    ::close(fd);
    if (mem == MAP_FAILED) return -1;
    NAT_RES_ALLOC(NR_SHM_SEG, (size_t)st.st_size, mem);
    if (!shm_seg_image_check(mem, (size_t)st.st_size)) {
      NAT_RES_FREE(NR_SHM_SEG, (size_t)st.st_size, mem);
      munmap(mem, (size_t)st.st_size);
      return -1;  // forged/corrupt/foreign segment: reject loudly
    }
    g_seg_ptr.store((ShmSeg*)mem, std::memory_order_release);
    g_seg_total = (size_t)st.st_size;
  }
  for (int i = 0; i < kMaxWorkers; i++) {
    ShmWorkerHdr* w = whdr(i);
    uint32_t expect = 0;
    if (!w->state.compare_exchange_strong(expect, 3,
                                          std::memory_order_acq_rel,
                                          std::memory_order_acquire)) {
      continue;
    }
    int rc = pthread_mutex_lock(&w->fence);
    if (rc == EOWNERDEAD) {
      pthread_mutex_consistent(&w->fence);
      rc = 0;
    }
    if (rc != 0) {
      w->state.store(0, std::memory_order_release);
      return -1;
    }
    w->pid.store((int32_t)getpid(), std::memory_order_relaxed);
    g_my_slot = i;
    // the attach IS the first heartbeat: requests arriving between
    // attach and the worker's first take must route to the ring
    seg_now()->last_worker_poll_ms.store(mono_ms(), std::memory_order_relaxed);
    w->state.store(1, std::memory_order_release);
    seg_now()->attached.fetch_add(1, std::memory_order_acq_rel);
    return 0;
  }
  return -1;  // every slot taken
}

// Tensor-fabric PRODUCER attach (ISSUE 15): map the receiver's segment
// and claim a slot in the PUSH role — this process becomes the sole
// producer of the slot's request ring (its own threads serialize on the
// process-local g_fab_mu, exactly the per-ring single-producer-process
// discipline every ring here relies on), and the receiver (the segment
// creator) consumes its kind-8 records via nat_shm_fabric_take. The
// slot's robust fence is held for the producer's lifetime, so a
// producer SIGKILL surfaces as EOWNERDEAD on the receiver's probe and
// recover_producer_slot reclaims the slot. Unlike a worker attach, no
// PDEATHSIG is armed (a tensor producer is a peer with its own
// lifecycle, not a child) and the attached worker count is untouched.
// Returns the claimed slot (>= 0), or -1.
int nat_shm_producer_attach(const char* name) {
  if (g_my_prod_slot >= 0) return g_my_prod_slot;
  if (seg_now() == nullptr) {
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      return -1;
    }
    void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    ::close(fd);
    if (mem == MAP_FAILED) return -1;
    NAT_RES_ALLOC(NR_SHM_SEG, (size_t)st.st_size, mem);
    if (!shm_seg_image_check(mem, (size_t)st.st_size)) {
      NAT_RES_FREE(NR_SHM_SEG, (size_t)st.st_size, mem);
      munmap(mem, (size_t)st.st_size);
      return -1;  // forged/corrupt/foreign segment: reject loudly
    }
    g_seg_ptr.store((ShmSeg*)mem, std::memory_order_release);
    g_seg_total = (size_t)st.st_size;
  }
  for (int i = 0; i < kMaxWorkers; i++) {
    ShmWorkerHdr* w = whdr(i);
    uint32_t expect = 0;
    if (!w->state.compare_exchange_strong(expect, 3,
                                          std::memory_order_acq_rel,
                                          std::memory_order_acquire)) {
      continue;
    }
    int rc = pthread_mutex_lock(&w->fence);
    if (rc == EOWNERDEAD) {
      pthread_mutex_consistent(&w->fence);
      rc = 0;
    }
    if (rc != 0) {
      w->state.store(0, std::memory_order_release);
      return -1;
    }
    w->pid.store((int32_t)getpid(), std::memory_order_relaxed);
    g_my_prod_slot = i;
    w->state.store(4, std::memory_order_release);
    return i;
  }
  return -1;  // every slot taken
}

// Producer: stage `len` tensor bytes ONCE into this producer slot's blob
// arena and publish one kind-8 descriptor (aux = tag) toward the
// segment's receiver. The receiver reads the span IN PLACE through a
// nat_shm_fabric_take lease — producer-write -> arena -> consume, no
// intermediate copy anywhere. The ambient trace context rides the
// descriptor's sock_id/cid like nat_shm_push_tensor. Returns 0, or -1
// when the ring/arena is full (caller owns backpressure policy) or the
// slot was recovered from under us.
int nat_shm_fabric_push(const char* data, size_t len, uint64_t tag) {
  if (seg_now() == nullptr || g_my_prod_slot < 0) return -1;
  if (seg_now()->shutdown.load(std::memory_order_acquire) != 0) return -1;
  int i = g_my_prod_slot;
  ShmWorkerHdr* w = whdr(i);
  if (w->state.load(std::memory_order_seq_cst) != 4) return -1;
  const NatTraceCtx& tc = tls_nat_trace;
  // flight-recorder tap: same seam/shape as nat_shm_push_tensor
  if (nat_dump_enabled() && nat_dump_tick()) {
    char tag_m[32];
    int tag_n = snprintf(tag_m, sizeof(tag_m), "tensor/%llu",
                         (unsigned long long)tag);
    nat_dump_sample(NL_WORKER, "", 0, tag_m, (size_t)tag_n, nullptr, 0,
                    data, len, tc.trace_id, tc.span_id);
  }
  uint64_t pos, span;
  char* dst;
  {
    // the lock covers only the claim: the claimed cell/span are private
    // until the publish's seq store (nat_desc_ring.h contract), so
    // concurrent pushers overlap their payload memcpys
    std::lock_guard g(*g_fab_mu);
    if (!ring_begin_push(wreq(i), req_arena(i), len, &pos, &span, &dst)) {
      return -1;  // ring/arena full: backpressure
    }
  }
  if (len != 0) memcpy(dst, data, len);
  ring_publish(wreq(i), pos, 8, 0, tc.trace_id, (int64_t)tc.span_id, 0,
               span, (uint32_t)len, tag);
  nat_counter_add(NS_FABRIC_PUSHES, 1);
  seg_now()->resp_doorbell.fetch_add(1, std::memory_order_seq_cst);
  if (seg_now()->resp_waiters.load(std::memory_order_seq_cst) != 0) {
    futex_wake_shared(&seg_now()->resp_doorbell);
  }
  return 0;
}

// Receiver (segment creator): take one pushed tensor record from any
// producer slot as a LEASE — a PyRequest* handle whose payload view
// (nat_req_field(h, 2)) points straight into the producer's blob arena.
// The lease may be held past further takes and released OUT OF ORDER
// with nat_req_free; leased payload bytes sit in the shm.span nat_res
// ledger row until release. Trace context comes back through
// nat_req_sock_id (trace_id) / nat_req_cid (producer span id), the tag
// through nat_req_aux. Null on timeout/shutdown.
void* nat_shm_fabric_take(int timeout_ms) {
  if (seg_now() == nullptr) return nullptr;
  for (int attempt = 0;; attempt++) {
    for (int i = 0; i < kMaxWorkers; i++) {
      ShmWorkerHdr* w = whdr(i);
      if (w->state.load(std::memory_order_seq_cst) != 4) continue;
      g_emit_busy[i].fetch_add(1, std::memory_order_seq_cst);
      PyRequest* req = nullptr;
      if (w->state.load(std::memory_order_seq_cst) == 4) {
        CellView c;
        while (ring_pop(wreq(i), &c)) {
          if (!span_sane(c)) continue;  // corrupt cell: drop, look again
          // natcheck:allow(resacct): PyRequest self-accounts in its ctor
          req = new PyRequest();
          req->kind = (int32_t)c.kind;
          req->sock_id = c.sock_id;  // producer trace_id
          req->cid = c.cid;          // producer span id
          req->aux = c.aux;
          req->shm_slot = i;
          req->shm_span = c.span_off;
          req->shm_epoch =
              g_slot_epoch[i].load(std::memory_order_acquire);
          req->shm_lease = true;
          req->shm_span_bytes = c.payload_len;
          req->shm_view[2] = span_payload(req_arena(i), c.span_off);
          req->shm_view_len[2] = c.payload_len;
          NAT_REF_ACQUIRED(req, shm.lease);
          NAT_RES_ALLOC(NR_SHM_SPAN, c.payload_len, req);
          g_fab_leases[i].fetch_add(1, std::memory_order_acq_rel);
          nat_counter_add(NS_FABRIC_TAKES, 1);
          break;
        }
      }
      g_emit_busy[i].fetch_sub(1, std::memory_order_seq_cst);
      if (req != nullptr) return req;
    }
    if (seg_now()->shutdown.load(std::memory_order_acquire) != 0) {
      return nullptr;
    }
    if (attempt >= 1) return nullptr;  // one bounded wait per call
    uint32_t db = seg_now()->resp_doorbell.load(std::memory_order_seq_cst);
    seg_now()->resp_waiters.fetch_add(1, std::memory_order_seq_cst);
    bool ready = false;
    for (int i = 0; i < kMaxWorkers && !ready; i++) {
      ready = whdr(i)->state.load(std::memory_order_acquire) == 4 &&
              ring_has_data(wreq(i));
    }
    if (!ready && seg_now()->shutdown.load(std::memory_order_acquire) == 0) {
      futex_wait_shared(&seg_now()->resp_doorbell, db,
                        timeout_ms > 0 ? timeout_ms : 200);
    }
    seg_now()->resp_waiters.fetch_sub(1, std::memory_order_seq_cst);
  }
}

// Worker: take one request; returns a PyRequest* handle compatible with
// the nat_req_* accessors (+ nat_req_free), or null on timeout. The
// string fields are VIEWS into the blob arena (zero-copy); freeing the
// request releases the span.
void* nat_shm_take_request(int timeout_ms) {
  if (seg_now() == nullptr || g_my_slot < 0) return nullptr;
  ShmWorkerHdr* w = whdr(g_my_slot);
  ShmRing* r = wreq(g_my_slot);
  // liveness heartbeat for the parent's all-workers-dead fallback
  seg_now()->last_worker_poll_ms.store(mono_ms(), std::memory_order_relaxed);
  for (int attempt = 0;; attempt++) {
    CellView c;
    while (ring_pop(r, &c)) {
      seg_now()->last_worker_poll_ms.store(mono_ms(),
                                       std::memory_order_relaxed);
      if (!span_sane(c)) continue;  // corrupt cell: drop, look again
      // natfault worker site: die or stall EXACTLY here — descriptor
      // consumed, response unpublished — the window the robust-fence
      // recovery (EOWNERDEAD probe, drain, scrub, fast-reap) exists
      // for. worker:kill@N drives test_shm_worker_crash's SIGKILL
      // scenario through the fault table.
      NatFaultAct fwk = NAT_FAULT_POINT(NF_WORKER);
      if (fwk.action == NF_KILL) {
        raise(SIGKILL);
      } else if (fwk.action == NF_STALL || fwk.action == NF_DELAY) {
        nat_fault_delay_ms(fwk.delay_ms);
      }
      // natcheck:allow(resacct): PyRequest self-accounts in its ctor
      PyRequest* req = new PyRequest();
      req->kind = (int32_t)c.kind;
      req->sock_id = c.sock_id;
      req->cid = c.cid;
      req->aux = c.aux;
      tls_take_ns = nat_now_ns();  // handling-start anchor (worker span)
      req->shm_slot = g_my_slot;
      req->shm_span = c.span_off;
      // the request's field views pin this arena span until
      // nat_req_free -> shm_req_span_release; the pinned payload bytes
      // sit in the shm.span ledger row for their whole lease
      NAT_REF_ACQUIRED(req, shm.span);
      req->shm_span_bytes = c.payload_len;
      NAT_RES_ALLOC(NR_SHM_SPAN, c.payload_len, req);
      char* arena = req_arena(g_my_slot);
      const char* p = span_payload(arena, c.span_off);
      const char* end = p + c.payload_len;
      if (c.kind == 8) {  // bulk tensor record: raw blob, no framing
        req->shm_view[2] = p;
        req->shm_view_len[2] = c.payload_len;
        return req;
      }
      const char *svc, *mth, *meta, *pay;
      size_t svc_n, mth_n, meta_n, pay_n;
      if (!get_blob(p, end, &svc, &svc_n) ||
          !get_blob(p, end, &mth, &mth_n) ||
          !get_blob(p, end, &meta, &meta_n) ||
          !get_blob(p, end, &pay, &pay_n)) {
        delete req;  // corrupt record (releases the span); look again
        continue;
      }
      req->shm_view[0] = svc;
      req->shm_view_len[0] = svc_n;
      req->shm_view[1] = mth;
      req->shm_view_len[1] = mth_n;
      req->shm_view[4] = meta;
      req->shm_view_len[4] = meta_n;
      req->shm_view[2] = pay;
      req->shm_view_len[2] = pay_n;
      return req;
    }
    if (seg_now()->shutdown.load(std::memory_order_acquire) != 0) {
      return nullptr;
    }
    if (attempt >= 1) return nullptr;  // one bounded wait per call
    uint32_t db = w->req_doorbell.load(std::memory_order_seq_cst);
    w->req_waiters.fetch_add(1, std::memory_order_seq_cst);
    if (!ring_has_data(r) &&
        seg_now()->shutdown.load(std::memory_order_acquire) == 0) {
      futex_wait_shared(&w->req_doorbell, db,
                        timeout_ms > 0 ? timeout_ms : 200);
    }
    w->req_waiters.fetch_sub(1, std::memory_order_seq_cst);
  }
}

// Worker: push a response record (kind 3 = serialized HTTP response,
// kind 4 = gRPC payload + status + message). Blocks (bounded backoff)
// while the descriptor ring or blob arena is full — the arena IS the
// backpressure bound on worker output.
int nat_shm_respond(int kind, uint64_t sock_id, int64_t seq,
                    const char* payload, size_t payload_len, int32_t status,
                    const char* message, int close_after) {
  if (seg_now() == nullptr || g_my_slot < 0) return -1;
  size_t msg_len = message != nullptr ? strlen(message) : 0;
  // + the 16B worker-timing blob (take_ns, respond_ns) the parent's
  // emit stitches into the worker span
  size_t blob_len = 12 + payload_len + msg_len + 16;
  // can NEVER fit (response larger than the whole blob arena): fail now
  // instead of spinning on backpressure that cannot clear — the parent
  // reaper answers the request
  if (blob_len + 8 + 128 > seg_now()->arena_bytes) return -1;
  ShmRing* r = wresp(g_my_slot);
  char* arena = resp_arena(g_my_slot);
  // BOUNDED backpressure: the arena normally frees within a drain pass,
  // but a client that stops reading can pin a user-block span (and so
  // the ring arena behind it) indefinitely — a worker must not wedge its
  // whole take loop on one glacial connection; give up and let the
  // parent's reaper answer this request
  auto give_up =
      std::chrono::steady_clock::now() + std::chrono::seconds(10);
  for (;;) {
    if (seg_now()->shutdown.load(std::memory_order_acquire) != 0) return -1;
    uint64_t pos, span;
    char* dst;
    bool ok;
    {
      std::lock_guard g(*g_resp_mu);
      ok = ring_begin_push(r, arena, blob_len, &pos, &span, &dst);
    }
    if (!ok) {  // ring/arena full: bounded backoff until the drain frees
      if (std::chrono::steady_clock::now() >= give_up) return -1;
      std::this_thread::sleep_for(std::chrono::microseconds(200));
      continue;
    }
    char* p = dst;
    put_blob(p, payload, payload_len);
    put_blob(p, message, msg_len);
    uint64_t times[2] = {tls_take_ns, nat_now_ns()};
    put_blob(p, (const char*)times, sizeof(times));
    ring_publish(r, pos, (uint8_t)kind, close_after != 0 ? 1 : 0, sock_id,
                 seq, status, span, (uint32_t)blob_len, 0);
    seg_now()->resp_doorbell.fetch_add(1, std::memory_order_seq_cst);
    if (seg_now()->resp_waiters.load(std::memory_order_seq_cst) != 0) {
      futex_wake_shared(&seg_now()->resp_doorbell);
    }
    return 0;
  }
}

// ---------------------------------------------------------------------------
// bulk-tensor entry + transport microbenchmarks
// ---------------------------------------------------------------------------

// Parent: stage `len` tensor/user bytes straight into a worker's blob
// arena and publish one kind-8 descriptor (aux = tag). This is the seam
// the device lane / future ICI transport stages through: one memcpy into
// registered shared memory, a 64-byte descriptor on the ring, and the
// consumer reads in place. Returns 0, or -1 when every ring is full (the
// caller owns backpressure policy).
int nat_shm_push_tensor(const char* data, size_t len, uint64_t tag) {
  if (seg_now() == nullptr) return -1;
  // kind-8 descriptors have no connection, so the sock_id/cid fields are
  // free: they carry this thread's ambient trace context (nat_trace_set)
  // across the process boundary — the consumer reads them back through
  // nat_req_sock_id (trace_id) / nat_req_cid (parent span id).
  const NatTraceCtx& tc = tls_nat_trace;
  // flight-recorder tap (kind-8 descriptor seam): the staged tensor
  // bytes, method = "tensor/<tag>" — bulk records past the capture's
  // max_payload are skipped whole and counted as oversize
  if (nat_dump_enabled() && nat_dump_tick()) {
    char tag_m[32];
    int tag_n = snprintf(tag_m, sizeof(tag_m), "tensor/%llu",
                         (unsigned long long)tag);
    nat_dump_sample(NL_WORKER, "", 0, tag_m, (size_t)tag_n, nullptr, 0,
                    data, len, tc.trace_id, tc.span_id);
  }
  bool ok = push_to_some_worker(
      8, 0, tc.trace_id, (int64_t)tc.span_id, 0, len, tag,
      [&](char* dst) {
        if (len != 0) memcpy(dst, data, len);
      },
      nullptr);
  return ok ? 0 : -1;
}

// Parent-side throughput probe: push fixed-size records for `seconds`
// against live worker drains; returns GB/s (and the record count).
double nat_shm_push_bench(size_t record_bytes, double seconds,
                          uint64_t* out_records) {
  if (out_records != nullptr) *out_records = 0;
  if (seg_now() == nullptr || record_bytes == 0) return 0.0;
  char* buf = (char*)malloc(record_bytes);
  if (buf == nullptr) return 0.0;
  NAT_RES_ALLOC(NR_SHM_SEG, record_bytes, buf);
  memset(buf, 0x5a, record_bytes);
  uint64_t records = 0;
  auto t0 = std::chrono::steady_clock::now();
  auto deadline =
      t0 + std::chrono::microseconds((int64_t)(seconds * 1e6));
  for (;;) {
    if (nat_shm_push_tensor(buf, record_bytes, records) == 0) {
      records++;
      // amortize the clock read over bursts of successful pushes
      if ((records & 0x3f) != 0) continue;
    } else {
      // full: brief backoff before re-checking the clock
      std::this_thread::sleep_for(std::chrono::microseconds(50));
    }
    if (std::chrono::steady_clock::now() >= deadline) break;
  }
  double dt =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  NAT_RES_FREE(NR_SHM_SEG, record_bytes, buf);
  free(buf);
  if (out_records != nullptr) *out_records = records;
  return dt > 0 ? (double)records * (double)record_bytes / dt / 1e9 : 0.0;
}

// Worker-side native drain loop (the bench consumer): pops descriptors
// and releases their spans in place (no PyRequest, no FFI per record).
// Returns the number of records drained; exits after `idle_exit_ms`
// without data or on lane shutdown.
uint64_t nat_shm_worker_drain_bench(int idle_exit_ms) {
  if (seg_now() == nullptr || g_my_slot < 0) return 0;
  ShmWorkerHdr* w = whdr(g_my_slot);
  ShmRing* r = wreq(g_my_slot);
  char* arena = req_arena(g_my_slot);
  uint64_t drained = 0;
  if (idle_exit_ms <= 0) idle_exit_ms = 200;
  auto last_work = std::chrono::steady_clock::now();
  for (;;) {
    CellView c;
    bool got = false;
    while (ring_pop(r, &c)) {
      if (span_sane(c)) span_release(arena, c.span_off);
      drained++;
      got = true;
    }
    seg_now()->last_worker_poll_ms.store(mono_ms(), std::memory_order_relaxed);
    if (got) {
      last_work = std::chrono::steady_clock::now();
      continue;
    }
    if (seg_now()->shutdown.load(std::memory_order_acquire) != 0) break;
    // exit only after a FULL quiet window: futex returns early on wakes,
    // EAGAIN and EINTR, none of which mean the producer is done
    if (std::chrono::steady_clock::now() - last_work >=
        std::chrono::milliseconds(idle_exit_ms)) {
      break;
    }
    uint32_t db = w->req_doorbell.load(std::memory_order_seq_cst);
    w->req_waiters.fetch_add(1, std::memory_order_seq_cst);
    if (!ring_has_data(r) &&
        seg_now()->shutdown.load(std::memory_order_acquire) == 0) {
      futex_wait_shared(&w->req_doorbell, db,
                        idle_exit_ms < 50 ? idle_exit_ms : 50);
    }
    w->req_waiters.fetch_sub(1, std::memory_order_seq_cst);
  }
  return drained;
}

}  // extern "C"

}  // namespace brpc_tpu
