// Internal header of the native RPC runtime — the seams of the brpc core
// (SURVEY.md §2.4), one translation unit per seam like the reference's
// socket.cpp / event_dispatcher.cpp / input_messenger.cpp / channel.cpp /
// server.cpp split:
//
//   nat_socket.cpp     NatSocket + versioned-id registry + ring datapath
//   nat_messenger.cpp  tpu_std cut loop, frame builders, console HTTP
//   nat_server.cpp     Dispatcher loops, NatServer lifecycle, py lane C API
//   nat_channel.cpp    NatChannel, dial/health-check, call paths C API
//   nat_bench.cpp      client bench harnesses
//
// See nat_socket.cpp's header comment for the design map to the reference.
#pragma once

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <stdio.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <functional>
#include <map>
#include <mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include "iobuf.h"
#include "nat_api.h"
#include "nat_dump.h"
#include "nat_fault.h"
#include "nat_lockrank.h"
#include "nat_refown.h"
#include "nat_stats.h"
#include "nat_wstack.h"
#include "ring_listener.h"
#include "rpc_meta.h"
#include "scheduler.h"
#include "timer_thread.h"

// ---- wiretrust annotation surface (tools/natcheck/wiretrust.py) ----
//
// NAT_WIRE(expr) marks `expr` as wire-origin bytes at the point where
// attacker- or corruption-controlled data enters a parser: socket drain
// fill buffers, shm descriptor cells, recordio loads, TDEV credentials.
// The macro is a compile-time no-op; the wiretrust static pass taints
// the value and verifies every use as a memcpy/memmove length,
// allocation size, container resize, array index, pointer offset or
// loop bound sits behind a dominating bounds check against a trusted
// limit. `// natcheck:wire: a, b` marks identifiers the same way where
// a macro is awkward (e.g. struct fields loaded from a mapped
// segment). Suppress a deliberate use with
// `// natcheck:allow(wiretrust): <bounds argument>`.
#ifndef NAT_WIRE
#define NAT_WIRE(x) (x)
#endif

namespace brpc_tpu {

// error codes shared with brpc_tpu/rpc/errors.py
inline constexpr int kENOSERVICE = 1001;
inline constexpr int kENOMETHOD = 1002;
inline constexpr int kEREQUEST = 1003;
inline constexpr int kETOOMANYFAILS = 1005;  // fan-out fail_limit reached
inline constexpr int kERPCTIMEDOUT = 1008;
inline constexpr int kEFAILEDSOCKET = 1009;
inline constexpr int kELIMIT = 2004;  // max concurrency reached

inline constexpr char kMagicRpc[4] = {'T', 'R', 'P', 'C'};

inline uint32_t rd_be32(const char* p) {
  return ((uint32_t)(uint8_t)p[0] << 24) | ((uint32_t)(uint8_t)p[1] << 16) |
         ((uint32_t)(uint8_t)p[2] << 8) | (uint32_t)(uint8_t)p[3];
}
inline void wr_be32(char* p, uint32_t v) {
  p[0] = (char)(v >> 24);
  p[1] = (char)(v >> 16);
  p[2] = (char)(v >> 8);
  p[3] = (char)v;
}

class Dispatcher;
class NatServer;
class NatChannel;
struct HttpSessionN;
struct H2SessionN;
struct SslSessionN;
struct HttpCliSessN;
struct H2CliSessN;
struct RedisSessN;
struct RedisStoreN;
struct PyRequest;

// ---------------------------------------------------------------------------
// NatSocket + versioned-id registry (socket_inl.h:28-185 shape)
// ---------------------------------------------------------------------------

// One queued socket write — a node of the wait-free MPSC write stack
// (the reference's WriteRequest, socket.cpp:115). Pooled per thread.
struct WriteReq {
  nat::atomic<WriteReq*> wnext{nullptr};
  IOBuf data;
};

WriteReq* wreq_alloc();
void wreq_free(WriteReq* r);

struct NatSocket {
  int fd = -1;
  // atomic: the server-stop scan reads ids of slots that sock_create may
  // concurrently be recycling (relaxed loads compile to plain loads here)
  std::atomic<uint64_t> id{0};
  Dispatcher* disp = nullptr;
  NatServer* server = nullptr;    // set on accepted connections
  NatChannel* channel = nullptr;  // set on client connections

  std::atomic<bool> failed{false};
  // (version<<32)|refcount in ONE atomic (the _versioned_ref of
  // socket_inl.h:28-78): addressing CAS-increments the refcount only
  // while the version matches, so a stale id can never revive a recycled
  // socket, and no registry lock is needed on the per-event/per-call path.
  std::atomic<uint64_t> versioned_ref{0};
  uint32_t next_version = 1;  // owner-only; assigned at (re)creation

  // read side: drained inline by the owning dispatcher loop (single
  // reader per socket by construction)
  IOBuf in_buf;

  // write side — the wait-free MPSC write stack (nat_wstack.h, the
  // reference Socket's write discipline): writers push whole frames with
  // one atomic exchange; the empty-head winner becomes the SINGLE
  // drainer. The fields below the stack are DRAINER-OWNED — only the
  // current role holder (inline caller, KeepWrite fiber, ring-send
  // completion, retry pass) touches them, and role handoffs synchronize
  // through scheduler queues / the ring completion queue, so they need
  // no lock at all.
  WStack<WriteReq> wstack;
  WriteReq* wcur = nullptr;   // FIFO-chain terminator (== last observed
                              // stack head); kept alive for grab_more
  IOBuf wbuf;                 // gathered-but-unwritten bytes (drainer)
  bool ring_sending = false;  // a fixed-buffer send is in flight (the
                              // role is parked on its completion)
  size_t ring_inflight = 0;   // bytes submitted, awaiting completion
  Butex epollout;       // bumped by the dispatcher on EPOLLOUT
  // epoll_ctl MOD arbitration for EPOLLOUT arm/disarm — COLD path only
  // (kernel socket buffer full); guards epoll_events so a finished
  // KeepWrite fiber's disarm cannot clobber its successor's arm.
  NatMutex<kLockRankSockEpoll> epollctl_mu;
  uint32_t epoll_events = 0;  // currently-armed event mask
  // Deferred-write mode (the fork's io_uring submission-batching
  // discipline, ring_listener.h): write() only queues; a writer fiber
  // scheduled behind the currently-ready fibers drains everything they
  // appended in ONE writev. Throughput over per-call latency.
  bool defer_writes = false;

  // Raw python-lane mode (the multi-protocol-port sniff-once-and-remember
  // discipline, input_messenger.h:33-154): once non-tpu_std bytes are
  // seen on a raw-fallback server, ALL further input on this connection
  // is shovelled to the Python protocol stack as ordered raw chunks.
  // atomic: set by the reading thread, read by set_failed from any
  // thread (server stop, nat_sock_set_failed). py_raw_seq stays plain —
  // only the single reading thread touches it.
  std::atomic<bool> py_raw{false};
  uint64_t py_raw_seq = 0;
  // streaming frames cut natively on this socket (kind-5 ordering);
  // py_streams mirrors py_raw's close-notice duty for stream sessions
  std::atomic<bool> py_streams{false};
  uint64_t stream_seq = 0;
  // Large-payload fill mode (the IOBuf→HBM zero-copy north star's
  // socket leg): a big TSTR DATA payload fills its PyRequest buffer
  // STRAIGHT from the socket/ring-buffer — in_buf (and its copy) is
  // bypassed for the payload bytes. Owned by the reading thread; freed
  // on socket teardown.
  PyRequest* fill_req = nullptr;
  size_t fill_off = 0;
  // tpu_std bulk-frame fill mode (read-side arena blocks, the
  // registered-pool read path of the reference's rdma config): when a
  // frame header announces a body >= kBulkFillMin that is not yet
  // buffered, the remaining bytes read STRAIGHT into one pooled bulk
  // slab (iob_bulk_acquire) that joins in_buf as a single arena-backed
  // USER block on completion — the whole frame body is then one
  // contiguous ref, so meta/payload/attachment cut zero-copy and the
  // echo/write path emits one iovec instead of ~128 8KB blocks per MB.
  // Owned by the reading thread; released on socket teardown.
  char* bulk_buf = nullptr;
  size_t bulk_cap = 0;  // slab capacity (the pool-release key)
  size_t bulk_len = 0;  // frame body length (fill target)
  size_t bulk_off = 0;  // filled prefix

  // Native protocol sessions (the per-connection parse state the
  // reference keeps in Socket::_parsing_context, socket.h:793): owned by
  // the single reading thread; freed on recycle. Sniffed once per
  // connection like py_raw.
  HttpSessionN* http = nullptr;  // native HTTP/1.1 session
  H2SessionN* h2 = nullptr;      // native h2/gRPC session
  RedisSessN* redis = nullptr;   // native RESP session
  // client-side protocol sessions (the reference's client half of
  // http_rpc_protocol.cpp / http2_rpc_protocol.cpp): attached when the
  // owning channel speaks HTTP/h2 instead of tpu_std
  HttpCliSessN* httpc = nullptr;
  H2CliSessN* h2c = nullptr;

  // Graceful close (Connection: close semantics): once set, the socket
  // fails as soon as the write queue drains — queued bytes flush first,
  // then shutdown sends FIN.
  std::atomic<bool> close_after_drain{false};

  // The connection has carried at least one tpu_std frame: the quiesce
  // lame-duck pass may speak tpu_std back on it (a SHUTDOWN control
  // frame would poison any other protocol). Reading thread stores,
  // quiesce scan reads — atomic for the cross-thread read only.
  std::atomic<bool> spoke_tpu_std{false};

  // TLS (the Socket-level SSLState of socket.h:539-540): set when the
  // first record on a TLS-enabled server port sniffs as a handshake;
  // in_buf then holds PLAINTEXT only (read paths feed ciphertext through
  // the session), and write() encrypts before queueing. ssl_declined
  // remembers a plaintext peer so the sniff runs once.
  SslSessionN* ssl_sess = nullptr;
  bool ssl_declined = false;

  // Per-connection observability (the native /connections row,
  // connections_service.cpp role): relaxed atomics — each is written by
  // one thread at a time (reader loop / drain-role holder) and read by
  // the snapshot walker. c_unwritten tracks bytes queued on the write
  // stack that the kernel has not yet accepted (the UnwrittenBytes
  // column); saturating-subtracted so a reset racing a push can never
  // wrap it negative. c_in_msgs counts protocol messages parsed off the
  // wire; c_out_msgs counts messages emitted INTO the session/write
  // stack — batch emit sites (http/h2/redis reorder windows, tpu_std
  // batches) count before the flush outcome is known, so on a socket
  // that fails mid-flush out_msgs may exceed what reached the wire
  // (failed sockets are excluded from /connections, so the skew is
  // only ever visible through a raw snapshot).
  // /connections visibility gate: set (release) only after the creating
  // thread finished setup (fd, peer, disp, channel/server, client
  // session attach), so the snapshot walker — which can pin the socket
  // the instant sock_create publishes versioned_ref — never reads those
  // plain fields mid-write. Server-side protocol session pointers are
  // sniffed later and stay outside the gate (see conn_fill_row).
  std::atomic<bool> conn_visible{false};
  std::atomic<uint64_t> c_in_bytes{0};
  std::atomic<uint64_t> c_out_bytes{0};
  std::atomic<uint64_t> c_in_msgs{0};
  std::atomic<uint64_t> c_out_msgs{0};
  std::atomic<uint64_t> c_read_calls{0};
  std::atomic<uint64_t> c_write_calls{0};
  std::atomic<uint64_t> c_unwritten{0};
  // per-socket approximate memory (ISSUE 14's /connections column):
  // c_rdbuf = buffered-but-unparsed read bytes, settled once per drain
  // by the reading thread; c_parked = reorder-window bytes parked on
  // the protocol session (http/h2/redis out-of-order responses and
  // flow-control-blocked h2 sends), adjusted under the session lock.
  // mem_bytes in the snapshot row = unwritten + rdbuf + parked.
  std::atomic<uint64_t> c_rdbuf{0};
  std::atomic<uint64_t> c_parked{0};

  void conn_parked_add(uint64_t n) {
    c_parked.fetch_add(n, std::memory_order_relaxed);
  }
  void conn_parked_sub(uint64_t n) {
    uint64_t v = c_parked.load(std::memory_order_relaxed);
    while (!c_parked.compare_exchange_weak(
        v, v > n ? v - n : 0, std::memory_order_relaxed)) {
    }
  }
  // "ip:port" peer, written once at accept/dial before the socket joins
  // its dispatcher; snapshot readers may see "" during setup
  char peer[24] = {0};

  void conn_unwritten_sub(uint64_t n) {
    uint64_t v = c_unwritten.load(std::memory_order_relaxed);
    while (!c_unwritten.compare_exchange_weak(
        v, v > n ? v - n : 0, std::memory_order_relaxed)) {
    }
  }

  // io_uring datapath: (generation<<32 | file index) on the OWNING
  // dispatcher's ring when this socket's reads ride the provided-buffer
  // ring (-1 = epoll lane); the generation lets the ring reject stale
  // rearms/sends after the slot is recycled. `ring` is the per-loop
  // RingListener the slot lives in (loops never share a ring). Send
  // state lives in the drainer-owned block above: one in-flight
  // fixed-buffer send at a time keeps ordering (the fork's
  // io_uring_write_req_, socket.h:632-636).
  std::atomic<int64_t> ring_ref{-1};  // atomic: drain workers read it
                                      // while accept/set_failed write it
  RingListener* ring = nullptr;  // set at adopt, before ring_ref publishes

  void add_ref() { versioned_ref.fetch_add(1, std::memory_order_relaxed); }
  void release();
  void reset_for_reuse();
  int write(IOBuf&& frame);      // encrypts first on TLS sockets
  int write_raw(IOBuf&& frame);  // wire bytes as-is (TLS records)
  // wait-free enqueue only (no drain): true = the caller became the
  // drainer and MUST follow up with wdrive()/flush_chain(). The ordered
  // protocol lanes push under their session locks (order on the wire ==
  // emission order) and drive the drain after unlocking.
  bool write_push(IOBuf&& frame);
  // head == nullptr: nothing queued, nobody draining — the "everything
  // flushed" predicate of the graceful-close paths.
  bool write_idle() const { return wstack.empty(); }
  // Graceful close, race-free against the drain role's release: store
  // the flag, seq_cst fence, THEN check idleness — pairs with the
  // role-release side (fence between grab_more's head CAS and its
  // close_after_drain load), so one side always sees the other (the
  // Dekker pairing write_mu used to provide). Idempotent.
  void arm_close_after_drain();
  // role-holder entries (see nat_socket.cpp)
  void wdrive();            // dispatch: ring submit / inline writev
  bool flush_chain();       // epoll lane; false = EAGAIN (role retained)
  void wring_continue();    // ring lane submission step
  void write_release_all(); // failed socket: free chain + release role
  void wgather();           // fold linked nodes into wbuf (keep terminator)
  bool wrefill();           // true = role released (stack empty)
  void set_failed();
  void arm_epollout();
  void disarm_epollout();
};

// Socket registry — ResourcePool discipline (butil/resource_pool.h +
// socket_inl.h): NatSocket objects are slab-allocated and NEVER freed, so
// a slot index is a permanently-valid pointer; liveness is governed solely
// by the (version, refcount) atomic inside the socket. Lookups take no
// lock; the alloc mutex only guards slab growth and the index freelist.
inline constexpr uint32_t kSockSlabBits = 10;
inline constexpr uint32_t kSockSlabSize = 1u << kSockSlabBits;  // 1024
inline constexpr uint32_t kSockSlabs = 1024;                    // 1M max

// slab entries are atomic: sock_create publishes a new socket with a
// release store that a concurrent sock_at (server-stop scan) acquires —
// no reader can observe a half-constructed NatSocket (ADVICE r3 #1)
extern std::atomic<std::atomic<NatSocket*>*> g_sock_slab[kSockSlabs];
extern NatMutex<kLockRankSockAlloc> g_sock_alloc_mu;
extern std::vector<uint32_t>& g_sock_free;  // leaked: see nat_socket.cpp
extern uint32_t g_sock_next_idx;

inline NatSocket* sock_at(uint32_t idx) {
  std::atomic<NatSocket*>* slab =
      g_sock_slab[idx >> kSockSlabBits].load(std::memory_order_acquire);
  if (slab == nullptr) return nullptr;
  return slab[idx & (kSockSlabSize - 1)].load(std::memory_order_acquire);
}

NatSocket* sock_create();
NatSocket* sock_address(uint64_t id);
// Pin `s` regardless of its id version (the /connections walker: any
// live refcount qualifies, even mid-teardown) — the second borrow
// primitive beside sock_address; nullptr when the slot holds no
// reference. The returned pin is a sock.borrow like sock_address's.
NatSocket* sock_try_pin(NatSocket* s);
void sock_unregister(NatSocket* s);

// /connections peer column: "ip:port" formatted once at socket setup.
inline void sock_set_peer(NatSocket* s, const char* ip, int port) {
  snprintf(s->peer, sizeof(s->peer), "%s:%d", ip, port);
}
// getpeername variant for accepted fds (defined in nat_socket.cpp).
void sock_set_peer_fd(NatSocket* s);

// ring datapath seams (defined in nat_socket.cpp). One RingListener per
// dispatcher loop (the event_dispatcher_num x io_uring product of the
// fork): loops never share an SQ, so submissions from different cores
// never contend on one sq_mu_. g_rings is leaked for the usual exit
// reasons; entries are created once under g_rt_mu and never removed.
extern std::vector<RingListener*>& g_rings;
extern std::atomic<bool> g_rings_ready;  // build complete; gates readers
extern std::atomic<bool> g_use_ring;
bool ring_drain();                         // drain every ring (idle hook)
bool ring_drain_one(RingListener* ring);   // poller inline drain
bool try_ring_adopt(NatSocket* s);
void keep_write_fiber(void* arg);

// ---------------------------------------------------------------------------
// Dispatcher — one epoll loop feeding the fiber scheduler
// ---------------------------------------------------------------------------

class Dispatcher {
 public:
  int epfd = -1;
  int wake_fd = -1;  // eventfd to break epoll_wait on stop
  int idx = 0;       // position in g_disps (the /connections disp column)
  std::thread thread;
  std::atomic<bool> stop{false};
  // listen sockets: fd -> server
  NatMutex<kLockRankListen> listen_mu;
  std::unordered_map<int, NatServer*> listeners;
  // Listener fds whose CLOSE is deferred to the loop thread: the loop
  // may be inside accept_loop(fd) when a stop/quiesce tears the
  // listener down — closing from the caller thread lets the fd number
  // be recycled under a concurrently-running accept (the acceptor
  // teardown race). remove_listener unregisters + parks the fd here;
  // run() closes parked fds at the top of its next round, when no
  // accept_loop on this loop can still reference them.
  NatMutex<kLockRankDispClose> pend_close_mu;
  std::vector<int> pend_close_fds;
  // per-loop io_uring instance (nullptr = epoll only); owned by g_rings
  RingListener* ring = nullptr;
  // observability (/vars nat_dispatcher_* rows): connections this loop
  // owns right now, and epoll_wait rounds that delivered events
  std::atomic<int64_t> sockets_owned{0};
  std::atomic<uint64_t> wakeups{0};

  int start();
  void shutdown();

  // Register a connection socket for edge-triggered reads. The socket id
  // (not the pointer) rides in epoll data so stale events can't touch a
  // recycled socket.
  void add_consumer(NatSocket* s);
  void add_listener(int fd, NatServer* srv);
  // Unregister the listener and defer the fd close to the loop thread
  // (see pend_close_fds). Safe from any thread; idempotent per fd.
  void remove_listener(int fd);

  void run();
  void accept_loop(int listen_fd, NatServer* srv);
};

// Dispatcher pool (-event_dispatcher_num analog, event_dispatcher.cpp:30)
extern std::vector<Dispatcher*>& g_disps;  // leaked: see nat_server.cpp
extern Dispatcher* g_disp;  // g_disps[0]: listeners + console
extern NatServer* g_rpc_server;
extern NatMutex<kLockRankRuntime> g_rt_mu;

// Shard a new socket across the loop pool. With >= 2 loops, accepted
// (server) and dialed (client) sockets round-robin over DISJOINT halves
// of the pool so an in-process loopback bench never multiplexes both
// runtimes' hot sockets through one loop (the cross-runtime
// interference the single-core bench lanes used to include).
Dispatcher* pick_dispatcher(bool client_side = false);
int ensure_runtime(int nworkers);
// Unregister every nat_rpc_server_add_port listener (stop + quiesce
// teardown). Caller holds g_rt_mu. Defined in nat_server.cpp.
void server_remove_extra_ports_locked(NatServer* srv);

// ---------------------------------------------------------------------------
// NatServer
// ---------------------------------------------------------------------------

// Native handler: fills response payload/attachment (zero-copy IOBuf) or an
// error. Runs inline in the reader fiber — must not block.
struct NativeHandlerCtx {
  IOBuf* req_payload = nullptr;
  IOBuf* req_attachment = nullptr;
  IOBuf resp_payload;
  IOBuf resp_attachment;
  int32_t error_code = 0;
  std::string error_text;
};
using NativeHandler = std::function<void(NativeHandlerCtx&)>;

// Native HTTP handler (the builtin-service-in-C++ discipline of
// server.cpp:468-563): runs inline in the reading thread — must not block.
struct HttpHandlerCtxN {
  std::string_view verb;
  std::string_view path;
  std::string_view body;
  int status = 200;
  const char* content_type = "text/plain";
  IOBuf resp_body;
};
using HttpHandlerN = std::function<void(HttpHandlerCtxN&)>;

// A request handed to the Python lane (usercode_backup_pool discipline:
// Python user code runs on pthreads, not fiber stacks).
// kind: 0 = parsed tpu_std request; 1 = raw bytes for the Python protocol
// stack (cid = per-socket sequence number for in-order reassembly across
// the pthread pool); 2 = connection closed (session cleanup); 3 = parsed
// HTTP/1.1 request (service = method verb, method = path, meta_bytes =
// "k:v\n" header lines, cid = native http session token); 4 = parsed
// gRPC-over-h2 request (method = ":path", payload = de-framed message,
// meta_bytes = header lines, cid = h2 stream id); 5 = streaming frame
// (aux = dest stream id, compress_type = frame type DATA/FEEDBACK/CLOSE,
// cid = per-socket sequence for ordered delivery, payload = frame body);
// 8 = bulk tensor record (shm descriptor lane, aux = caller tag; the
// connection-less sock_id/cid fields carry the pusher's ambient trace
// context: sock_id = trace_id, cid = parent span id).
struct PyRequest;

// shm descriptor lane (nat_shm_lane.cpp): release the blob-arena span an
// arena-backed PyRequest's field views point into (no-op otherwise).
void shm_req_span_release(PyRequest* r);

// ---------------------------------------------------------------------------
// overload protection (nat_overload.cpp): native server admission control
// — constant + gradient ("auto") limiters ported from
// brpc_tpu/rpc/concurrency_limiter.py, real ELIMIT wire responses, and a
// queue-deadline drop (expired requests rejected before dispatch).
// ---------------------------------------------------------------------------

// Nonzero while a limiter OR a queue deadline is configured: the
// enqueue-side gate is one relaxed load when everything is off.
extern std::atomic<uint32_t> g_overload_on;

// Admission gate for one work request (kinds 0/3/4/6): stamps
// enqueue_ns, and when the limiter votes to reject, emits the per-lane
// ELIMIT wire response, frees `r` and returns false. On admit, marks
// r->admitted (the accounting token released by admission_on_complete).
bool overload_admit(PyRequest* r);
// True when a configured queue deadline has expired for `r`.
bool overload_expired(const PyRequest* r, uint64_t now_ns);
// Reject an expired queued request: ELIMIT response, accounting, free.
// Must be called with NO server/session locks held (it writes responses).
void overload_expire(PyRequest* r);
// One admitted request left the system; `latency_ns` feeds the gradient
// limiter when ok. Callers: ~PyRequest (in-process lane), the shm
// in-flight table's erase sites, overload_expire.
void admission_on_complete(uint64_t latency_ns, bool ok);
// Server (re)start hygiene: zero the in-flight count.
void overload_server_reset();

// ---------------------------------------------------------------------------
// graceful quiesce (nat_quiesce.cpp): the Server::Stop(timeout)/Join
// lifecycle for the native runtime — stop accepting, lame-duck every
// live connection per protocol, drain admitted work under a deadline,
// reject new arrivals with the PR-5 ELIMIT/503/RESOURCE_EXHAUSTED wire
// shapes (never a reset), then close sockets once their wstack is idle.
// ---------------------------------------------------------------------------

// Nonzero from quiesce start until the server is stopped/restarted: the
// enqueue gate rejects new WORK arrivals while set (one relaxed load on
// the hot path, colocated with the overload gate).
extern std::atomic<uint32_t> g_draining;
// Live kind-0 (tpu_std py-lane) work requests: created at enqueue,
// retired by ~PyRequest — the tpu_std half of the drain predicate (the
// HTTP/h2/RESP halves live in their session reorder windows).
extern std::atomic<int64_t> g_tpu_work_live;
// Reject one work request during the drain window: per-lane ELIMIT /
// 503 / RESOURCE_EXHAUSTED wire response ("server draining"); tpu_std
// rejections carry the SHUTDOWN meta bit so a client that missed the
// lame-duck frame still learns to redial. Frees `r`. Defined in
// nat_overload.cpp (shares the detached reject fiber).
void drain_reject(PyRequest* r);

// A py-lane request that represents admitted WORK (an RPC a client is
// waiting on) as opposed to lifecycle chatter: the one predicate the
// overload admitter, the drain enqueue gate, and the drain-deadline
// straggler sweep all share — a new work kind added here gates/503s
// everywhere at once.
inline bool is_work_kind(int32_t kind) {
  return kind == 0 || kind == 3 || kind == 4 || kind == 6;
}

// per-protocol lame-duck + drain-quiet hooks (each defined in its TU)
void h2_send_goaway(NatSocket* s);        // GOAWAY(last client sid seen)
bool h2_session_busy(NatSocket* s);       // streams/pending not yet quiet
void http_session_lame_duck(NatSocket* s);// next response: Connection: close
bool http_session_busy(NatSocket* s);     // responses still owed/parked
void redis_session_lame_duck(NatSocket* s);// close once window drains
bool redis_session_busy(NatSocket* s);    // replies still owed/parked
// meta-only tpu_std control frame carrying the SHUTDOWN bit
// (correlation_id 0) — the lame-duck signal on tpu_std connections.
void build_shutdown_frame(IOBuf* out);
// ELIMIT-class rejection that ALSO carries the SHUTDOWN bit (drain
// window: reject + "redial elsewhere" in one frame).
void build_reject_draining_frame(IOBuf* out, int64_t cid,
                                 int32_t error_code, const char* text);
// shm worker lane: no request is riding the rings right now
bool shm_lane_inflight_empty();
// client half: a peer signaled lame duck on `s` — detach it from the
// channel (in-flight completes here, new calls re-dial/re-balance) with
// no breaker penalty and no retry-budget burn. Defined nat_channel.cpp.
void channel_note_lame_duck(NatChannel* ch, NatSocket* s);
void channel_detach_socket(NatChannel* ch, NatSocket* s);

struct PyRequest {
  int32_t kind = 0;
  uint64_t sock_id = 0;
  int64_t cid = 0;
  int32_t compress_type = 0;
  uint64_t aux = 0;
  std::string service;
  std::string method;
  std::string payload;
  std::string attachment;
  std::string meta_bytes;  // full RpcMeta wire bytes: Python re-parses for
                           // log/trace ids, auth_data, timeout, tensors…
  // Large stream payloads (fill mode) live in a malloc'd buffer instead
  // of `payload`: malloc'd pages are lazily mapped, so no zero-fill pass
  // precedes the reads that populate them. nat_req_field(2) serves it.
  // The buffer GROWS with received bytes (big_cap doubles toward
  // big_len) so a 17-byte header claiming a huge body cannot reserve
  // the whole allocation up front (claim-without-send exhaustion).
  char* big_payload = nullptr;
  size_t big_len = 0;  // final payload size (frame-declared)
  size_t big_cap = 0;  // currently allocated
  // shm descriptor-ring backing (nat_shm_lane.cpp): slot >= 0 marks an
  // arena-resident record — the field views below point INTO the mapped
  // blob arena (read in place, no per-record copy) and stay valid until
  // this request is freed, which releases the span back to the arena.
  int32_t shm_slot = -1;
  uint64_t shm_span = 0;   // span-start offset (monotone) for the release
  // span-lease bookkeeping (tensor fabric, ISSUE 15): shm_span_bytes is
  // the leased payload size (the shm.span nat_res ledger row — payload
  // bytes are accounted ONCE per transfer, the structural zero-copy
  // witness); shm_lease marks a receiver-side fabric lease whose release
  // must be epoch-guarded (the producer slot may have been recovered
  // from under it) and decrement the slot's outstanding-lease count.
  uint32_t shm_span_bytes = 0;
  uint32_t shm_epoch = 0;
  bool shm_lease = false;
  const char* shm_view[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  size_t shm_view_len[5] = {0, 0, 0, 0, 0};
  // trace context parsed off the wire (RpcMeta trace fields /
  // x-bd-trace-* headers / gRPC metadata): trace_id = the caller's
  // trace, parent_span_id = the caller's span — consumed by the shm
  // lane's server-span records (shm_lane_offer / emit_response)
  uint64_t trace_id = 0;
  uint64_t parent_span_id = 0;
  // overload accounting (nat_overload.cpp): enqueue_ns stamped when a
  // limiter/deadline is configured; admitted = this request holds one
  // in-flight slot, released exactly once (dtor, or transferred to the
  // shm in-flight table when the request rides the worker rings).
  // admit_ok mirrors AutoLimiter.on_response's error filter: responders
  // that complete a request with an error clear it so the failure-storm
  // latency profile never inflates the gradient limiter's window.
  uint64_t enqueue_ns = 0;
  bool admitted = false;
  bool admit_ok = true;
  // quiesce drain accounting: this kind-0 request is counted in
  // g_tpu_work_live until freed (responders free at respond-time, so
  // liveness == "response not yet queued")
  bool drain_counted = false;
  // resource ledger (nat_res.h): PyRequests are allocated at five lanes'
  // cut loops and freed at four release sites — self-accounting in the
  // ctor/dtor covers every one of them with a single seam (allocation
  // sites carry natcheck:allow(resacct) notes pointing here). The
  // big_payload fill buffer accounts its grows in stream_fill_reserve.
  PyRequest() { NAT_RES_ALLOC(NR_SRV_PYREQ, sizeof(PyRequest), this); }
  ~PyRequest() {
    if (big_cap > 0) NAT_RES_FREE(NR_SRV_PYREQ, big_cap, big_payload);
    ::free(big_payload);
    if (shm_slot >= 0) shm_req_span_release(this);
    if (admitted) {
      NAT_REF_RELEASED(nat_ref_adm_anchor(), adm.pyreq);
      admission_on_complete(
          enqueue_ns != 0 ? nat_now_ns() - enqueue_ns : 0, admit_ok);
    }
    if (drain_counted) {
      g_tpu_work_live.fetch_sub(1, std::memory_order_acq_rel);
    }
    NAT_RES_FREE(NR_SRV_PYREQ, sizeof(PyRequest), this);
  }
};

// shm usercode lane (nat_shm_lane.cpp): true = request consumed by the
// worker-process rings (kinds 3/4 only, when enabled).
bool shm_lane_offer(PyRequest* r);

class NatServer {
 public:
  int listen_fd = -1;
  int port = 0;
  Dispatcher* disp = nullptr;
  std::atomic<uint64_t> requests{0};
  std::atomic<uint64_t> connections{0};
  // Lifetime (replaces the round-2 graveyard): the global registration
  // holds one reference, every accepted socket one, every py-lane taker
  // one while inside take_py — a stopped server is deleted when the last
  // connection/taker lets go, and stop->start cycles no longer leak
  // (server.h:426-441 Stop/Join-then-Start-again semantics).
  std::atomic<int> ref{1};

  void add_ref() { ref.fetch_add(1, std::memory_order_relaxed); }
  void release() {
    if (ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      NAT_REF_DEAD(this);  // refguard: every tag balanced before delete
      delete this;
    }
  }

  ~NatServer();  // drains py_q: late kind-2 notices enqueue after stop

  // frozen at start; std::less<> enables allocation-free string_view find
  std::map<std::string, NativeHandler, std::less<>> handlers;
  // native HTTP handlers keyed by exact path (checked before the py lane)
  std::map<std::string, HttpHandlerN, std::less<>> http_handlers;
  // flat view of `handlers` built at start: with a handful of handlers a
  // length-check + memcmp scan beats the per-request red-black-tree walk
  // the r04 profile surfaced
  std::vector<std::pair<std::string, const NativeHandler*>> handler_vec;

  void freeze_handlers() {
    handler_vec.clear();
    for (const auto& kv : handlers) {
      handler_vec.emplace_back(kv.first, &kv.second);
    }
  }

  const NativeHandler* find_handler(std::string_view key) const {
    for (const auto& kv : handler_vec) {
      if (kv.first.size() == key.size() &&
          memcmp(kv.first.data(), key.data(), key.size()) == 0) {
        return kv.second;
      }
    }
    return nullptr;
  }
  // Extra listening ports (nat_rpc_server_add_port — the swarm-backend
  // seam): port -> (listen fd, owning dispatcher). Guarded by g_rt_mu
  // like the primary listener registration; torn down with the server.
  std::map<int, std::pair<int, Dispatcher*>> extra_ports;

  bool py_lane_enabled = false;
  // Route unrecognized framing to the Python protocol stack instead of
  // failing the socket (set when a Python server with a full protocol
  // registry is mounted on this port).
  bool raw_fallback = false;
  // Parse HTTP/1.1 and h2/gRPC natively (kind 3/4 py-lane requests)
  // instead of shovelling raw bytes; set with nat_rpc_server_native_http.
  bool native_http = false;
  // Parse RESP natively (policy/redis_protocol.cpp role): 0 = off,
  // 1 = py-lane dispatch (kind 6), 2 = + native in-memory store for the
  // GET/SET command family (unknown commands still go to py handlers).
  int native_redis = 0;
  RedisStoreN* redis_store = nullptr;  // owned; freed in ~NatServer
  // TLS context (opaque SSL_CTX*, nat_ssl.cpp) — when set, connections
  // whose first record sniffs as a TLS handshake get a native SSL
  // session; plaintext peers keep working on the same port.
  void* ssl_ctx = nullptr;

  // Python lane MPSC queue (py_cv waits under py_mu: stays std::mutex)
  std::mutex py_mu;  // natcheck:rank(server.py, 57)
  std::condition_variable py_cv;
  std::deque<PyRequest*> py_q;
  bool py_stopping = false;

  void enqueue_py(PyRequest* r) {
    // graceful drain (nat_quiesce.cpp): after the lame-duck pass, new
    // WORK arrivals are rejected with the overload wire shapes instead
    // of dying with the socket — one relaxed load when not draining
    if (g_draining.load(std::memory_order_relaxed) != 0 &&
        is_work_kind(r->kind)) {
      drain_reject(r);
      return;
    }
    // admission control (nat_overload.cpp): one relaxed load when off;
    // a rejected request already answered ELIMIT on the wire and is gone
    if (g_overload_on.load(std::memory_order_relaxed) != 0 &&
        !overload_admit(r)) {
      return;
    }
    // drain predicate bookkeeping for the tpu_std py lane: these live
    // until the responder frees them, so a live count IS "responses
    // still owed" (the other lanes count via their reorder windows)
    if (r->kind == 0) {
      r->drain_counted = true;
      g_tpu_work_live.fetch_add(1, std::memory_order_acq_rel);
    }
    // counted AFTER the gate: kind 2 is a connection-drop control
    // message and admission-rejected requests never enter the lane —
    // neither inflates nat_py_dispatches. (Queue-deadline drops DO
    // count: they entered the lane and expired inside it; the drop
    // shows up in nat_queue_deadline_drops.)
    if (r->kind != 2) nat_counter_add(NS_PY_DISPATCHES, 1);
    // worker-process lane first (kinds 3/4 when enabled): usercode runs
    // across N interpreters instead of behind this process's GIL
    if ((r->kind == 3 || r->kind == 4) && shm_lane_offer(r)) return;
    {
      std::lock_guard g(py_mu);
      py_q.push_back(r);
    }
    py_cv.notify_one();
  }

  PyRequest* take_py(int timeout_ms) {
    // queue-deadline drop: requests that sat longer than the configured
    // budget are rejected HERE, before a Python worker spends usercode
    // time on them — the ELIMIT emits happen after py_mu is released
    // (the responders take session locks that rank below it).
    PyRequest* r = nullptr;
    PyRequest* expired[8];
    int nexp = 0;
    {
      std::unique_lock lk(py_mu);
      if (py_q.empty() && !py_stopping) {
        nat_cv_wait_for(py_cv, lk, std::chrono::milliseconds(timeout_ms));
      }
      uint64_t now = g_overload_on.load(std::memory_order_relaxed) != 0
                         ? nat_now_ns()
                         : 0;
      while (!py_q.empty()) {
        PyRequest* f = py_q.front();
        if (now == 0 || !overload_expired(f, now)) {
          py_q.pop_front();
          r = f;
          break;
        }
        // expired: never hand it to usercode — when this call's drop
        // budget is spent, leave the rest queued for the next take
        if (nexp >= 8) break;
        py_q.pop_front();
        expired[nexp++] = f;
      }
    }
    for (int i = 0; i < nexp; i++) overload_expire(expired[i]);
    return r;
  }

  // Batch take: one condvar round + one FFI crossing covers a whole
  // burst (the py lane's per-item wakeup was measurable at qps scale).
  int take_py_batch(PyRequest** out, int max, int timeout_ms) {
    PyRequest* expired[16];
    int nexp = 0;
    int n = 0;
    {
      std::unique_lock lk(py_mu);
      if (py_q.empty() && !py_stopping) {
        nat_cv_wait_for(py_cv, lk, std::chrono::milliseconds(timeout_ms));
      }
      uint64_t now = g_overload_on.load(std::memory_order_relaxed) != 0
                         ? nat_now_ns()
                         : 0;
      while (n < max && !py_q.empty()) {
        PyRequest* f = py_q.front();
        if (now != 0 && overload_expired(f, now)) {
          // expired work never reaches usercode; once this call's drop
          // budget is spent, stop (the rest drains on the next take)
          if (nexp >= 16) break;
          py_q.pop_front();
          expired[nexp++] = f;
          continue;
        }
        py_q.pop_front();
        out[n++] = f;
      }
    }
    for (int i = 0; i < nexp; i++) overload_expire(expired[i]);
    return n;
  }
};

// ---------------------------------------------------------------------------
// NatChannel (client half)
// ---------------------------------------------------------------------------

struct PendingCall {
  Butex done;  // 0 = in flight, 1 = complete
  int32_t error_code = 0;
  // protocol-level status riding beside the RPC error: HTTP status code
  // on the native HTTP client lane, grpc-status on the h2 client lane
  int32_t aux_status = 0;
  std::string error_text;
  IOBuf response;
  IOBuf attachment;
  // Small responses land here instead of the IOBuf: the typical RPC
  // reply is tens of bytes, and an inline copy skips the block
  // add_ref/release pair plus the ref bookkeeping entirely (the same
  // trade the short-buffer flat-copy makes in iobuf.cpp).
  uint8_t inline_len = 0;
  char inline_resp[56];

  const char* resp_data() const {
    return inline_len > 0 ? inline_resp : nullptr;
  }
  // Asynchronous completion (brpc's done-closure, controller.h): when
  // set, the response path invokes cb (which owns pc) instead of waking
  // a parked caller — the async RPC surface sync calls are built on.
  void (*cb)(PendingCall*, void*) = nullptr;
  void* cb_arg = nullptr;
  // Slot machinery (the versioned CallId discipline of bthread/id.h:38-60
  // + controller.h:655-664): calls live in never-freed slabs owned by
  // the channel; the correlation id packs (version, slot index), and a
  // single atomic word (version<<1 | pending) arbitrates completion —
  // whoever CASes the pending bit off owns the call. No lock, no map,
  // no allocation on the per-call path, and a late/duplicate response
  // (stale version) can never touch a recycled call.
  NatChannel* owner = nullptr;
  uint32_t slot_idx = 0;
  uint32_t next_free = 0;  // freelist link, encoded idx+1
  std::atomic<uint64_t> state{0};  // (version << 1) | pending_bit
  // call-begin timestamp (nat_stats client-lane latency: the round trip
  // lands in NL_CLIENT when the completion wins take_pending)
  uint64_t start_ns = 0;
  // client-span state (rpcz): copied from the caller's NatCallTrace by
  // begin_call BEFORE the pending bit publishes (after publish a racing
  // fail_all may complete + recycle this slot, so nothing may touch
  // these fields post-publish); the protocol lanes stamp the SAME
  // NatCallTrace's ids into the wire metadata, and the ok-completion in
  // take_pending submits the span.
  uint64_t trace_id = 0;        // 0 = no trace propagation for this call
  uint64_t span_id = 0;         // THIS call's span (the callee's parent)
  uint64_t parent_span_id = 0;  // the ambient span this call nests under
  bool span_sampled = false;
  uint8_t span_method_len = 0;
  char span_method[40];
};

// Per-call trace decision, taken ONCE on the caller's stack before
// begin_call: sampling stride + this thread's ambient context
// (tls_nat_trace) + the span label the lane knows. The lanes read wire
// ids from THIS struct (never from the PendingCall after publish).
struct NatCallTrace {
  uint64_t trace_id = 0;
  uint64_t span_id = 0;
  uint64_t parent_span_id = 0;
  bool sampled = false;
  uint8_t label_len = 0;
  char label[40];

  // "a<sep>b" span label (only when sampled: the snprintf is off the
  // untraced hot path)
  void set_label(const char* a, const char* sep, const char* b) {
    if (!sampled) return;
    int n = snprintf(label, sizeof(label), "%s%s%s", a, sep, b);
    label_len = (uint8_t)(n <= 0 ? 0
                          : (n < (int)sizeof(label) ? n
                                                    : (int)sizeof(label) - 1));
  }
};

inline NatCallTrace nat_begin_call_trace() {
  NatCallTrace tr;
  tr.sampled = nat_span_tick();
  const NatTraceCtx& tc = tls_nat_trace;
  if (tr.sampled || tc.trace_id != 0) {
    tr.trace_id = tc.trace_id != 0 ? tc.trace_id : nat_span_id63();
    tr.span_id = nat_span_id63();
    tr.parent_span_id = tc.span_id;
  }
  return tr;
}

void pc_free(PendingCall* pc);  // returns the slot to its channel

class NatChannel {
 public:
  static const uint32_t kIdxBits = 20;  // 1M concurrent calls per channel
  static const uint32_t kIdxMask = (1u << kIdxBits) - 1;
  static const uint32_t kSlabBits = 8;  // 256 calls per slab
  static const uint32_t kSlabSize = 1u << kSlabBits;
  static const uint32_t kMaxSlabs = 1u << (kIdxBits - kSlabBits);

  std::atomic<uint64_t> sock_id{0};
  // Wire protocol this channel speaks: 0 = tpu_std, 1 = HTTP/1.1,
  // 2 = h2/gRPC (the reference's per-channel protocol option,
  // channel.h ChannelOptions.protocol).
  int protocol = 0;
  std::string authority;  // Host / :authority for the HTTP/h2 lanes
  // Reconnect state (single-connection Channel semantics: the reference
  // re-establishes a failed single connection on use, and the health
  // checker revives it in the background — health_check.cpp:146-237).
  std::string peer_ip;
  int peer_port = 0;
  int connect_timeout_ms = 0;     // 0 = default guard
  int health_check_interval_ms = 0;  // 0 = no background revival
  bool defer_writes_flag = false;
  std::atomic<bool> closed{false};
  std::atomic<bool> hc_pending{false};
  // Lame-duck bookkeeping (graceful server churn): CLOCK_MONOTONIC ms of
  // the last lame-duck signal from the peer. While recent, drain-window
  // ELIMIT rejections are retried WITHOUT spending the retry budget and
  // the planned socket death feeds no breaker sample — planned churn is
  // routine, not failure.
  std::atomic<int64_t> lame_duck_ms{0};

  bool draining_recent() const {
    int64_t t = lame_duck_ms.load(std::memory_order_relaxed);
    return t != 0 &&
           (int64_t)(nat_now_ns() / 1000000ull) - t < 10000;
  }
  // Health-check re-dial backoff: the CURRENT chain's exponent (reset to
  // 0 when a chain starts and on revival, so the first retry stays fast;
  // only the single hc fiber advances it — atomic for the cross-thread
  // reset from set_failed).
  std::atomic<int> hc_backoff_shift{0};
  // Retry budget (brpc retry-dispersal discipline in token form): deci-
  // tokens; a retry spends 10, every success replenishes 1 up to the
  // cap, so an injected failure burst can spend at most budget/10
  // retries before new retries need fresh successes to pay for them.
  static const int kRetryBudgetCap = 100;
  std::atomic<int> retry_budget_decis{100};
  // Circuit breaker (two-EMA-window port of rpc/circuit_breaker.py):
  // default off; enabled via nat_channel_set_breaker. While broken and
  // inside the isolation window, channel_socket fails fast (no dial);
  // the health-check chain re-dials after expiry and resets the breaker.
  std::atomic<bool> breaker_enabled{false};
  std::atomic<bool> breaker_broken{false};
  std::atomic<int64_t> breaker_until_ms{0};  // CLOCK_MONOTONIC ms
  NatMutex<kLockRankBreaker> breaker_mu;
  double brk_short_ema = 0.0;          // under breaker_mu
  double brk_long_ema = 0.0;           // under breaker_mu
  int brk_isolation_ms = 0;            // under breaker_mu
  int64_t brk_last_isolation_ms = 0;   // under breaker_mu
  NatMutex<kLockRankReconnect> reconnect_mu;
  // Lifetime: the owning socket holds one reference (released in
  // ~NatSocket) and the opener holds one (released in nat_channel_close),
  // so a reader fiber mid-process_input can never see a freed channel.
  std::atomic<int> ref{1};

  void add_ref() { ref.fetch_add(1, std::memory_order_relaxed); }
  void release() {
    if (ref.fetch_sub(1, std::memory_order_acq_rel) == 1) {
      NAT_REF_DEAD(this);  // refguard: every tag balanced before delete
      delete this;
    }
  }

  // resource ledger: channels are allocated by channel_open (client
  // lane) and channel_create_lazy (cluster backends) and freed by the
  // refcount chain — ctor/dtor self-accounting covers every site (the
  // raw news carry natcheck:allow(resacct) notes pointing here).
  NatChannel() { NAT_RES_ALLOC(NR_CLUSTER, sizeof(NatChannel), this); }
  ~NatChannel() {
    for (uint32_t i = 0; i < kMaxSlabs; i++) {
      PendingCall* slab = slabs_[i].load(std::memory_order_acquire);
      if (slab != nullptr) {
        NAT_RES_FREE(NR_CLUSTER, kSlabSize * sizeof(PendingCall), slab);
        delete[] slab;
      }
    }
    NAT_RES_FREE(NR_CLUSTER, sizeof(NatChannel), this);
  }

  PendingCall* slot_at(uint32_t idx) {
    return &slabs_[idx >> kSlabBits].load(std::memory_order_acquire)
                [idx & (kSlabSize - 1)];
  }

  PendingCall* begin_call(int64_t* cid_out,
                          void (*cb)(PendingCall*, void*) = nullptr,
                          void* cb_arg = nullptr,
                          const NatCallTrace* tr = nullptr) {
    uint32_t idx = pop_free();
    if (idx == UINT32_MAX) return nullptr;  // slot space exhausted
    PendingCall* pc = slot_at(idx);
    uint64_t version =
        (pc->state.load(std::memory_order_relaxed) >> 1) + 1;
    pc->done.value.store(0, std::memory_order_relaxed);
    pc->error_code = 0;
    pc->aux_status = 0;
    pc->error_text.clear();
    pc->response.clear();
    pc->attachment.clear();
    pc->inline_len = 0;
    pc->cb = cb;
    pc->cb_arg = cb_arg;
    pc->owner = this;
    pc->slot_idx = idx;
    pc->start_ns = nat_now_ns();
    // client span + trace propagation, fully written BEFORE the pending
    // bit publishes (a racing fail_all may complete and recycle the
    // slot the instant the bit is visible). Callers that pass no trace
    // (bench harnesses) fall back to the stride decision with no label.
    if (tr != nullptr) {
      pc->span_sampled = tr->sampled;
      pc->trace_id = tr->trace_id;
      pc->span_id = tr->span_id;
      pc->parent_span_id = tr->parent_span_id;
      pc->span_method_len = tr->label_len;
      memcpy(pc->span_method, tr->label, tr->label_len);
    } else {
      pc->span_sampled = nat_span_tick();
      pc->span_method_len = 0;
      const NatTraceCtx& tc = tls_nat_trace;
      if (pc->span_sampled || tc.trace_id != 0) {
        pc->trace_id = tc.trace_id != 0 ? tc.trace_id : nat_span_id63();
        pc->span_id = nat_span_id63();
        pc->parent_span_id = tc.span_id;
      } else {
        pc->trace_id = 0;
        pc->span_id = 0;
        pc->parent_span_id = 0;
      }
    }
    nat_counter_add(NS_CLIENT_CALLS, 1);
    // everything above must be visible before the pending bit: a racing
    // fail_all completes through cb/butex the instant it sees the bit
    pc->state.store((version << 1) | 1, std::memory_order_release);
    *cid_out = (int64_t)((version << kIdxBits) | idx);
    return pc;
  }

  // Non-consuming peek: true while the call is still awaiting its first
  // completion (used by the backup-request timer to decide whether a
  // duplicate send is still useful).
  bool is_pending(int64_t cid) {
    uint32_t idx = (uint32_t)cid & kIdxMask;
    if (idx >= nslots_.load(std::memory_order_acquire)) return false;
    uint64_t expected = (((uint64_t)cid >> kIdxBits) << 1) | 1;
    return slot_at(idx)->state.load(std::memory_order_acquire) == expected;
  }

  // CAS the pending bit off; the winner owns the call. Stale cids (old
  // version) and double-completions lose the CAS and get nullptr.
  // `ok=false` marks an error completion (timeout, failed send, refused
  // stream): counted into nat_client_errors and kept OUT of the client
  // latency histogram — a 30s timeout is not a round trip. `planned`
  // marks a completion caused by the peer's GRACEFUL drain (GOAWAY-
  // refused stream, lame-duck retire): still an error to the caller,
  // but not a breaker sample — planned churn must not isolate a peer.
  PendingCall* take_pending(int64_t cid, bool ok = true,
                            bool planned = false) {
    uint32_t idx = (uint32_t)cid & kIdxMask;
    if (idx >= nslots_.load(std::memory_order_acquire)) return nullptr;
    PendingCall* pc = slot_at(idx);
    uint64_t expected = (((uint64_t)cid >> kIdxBits) << 1) | 1;
    if (pc->state.compare_exchange_strong(expected, expected & ~1ull,
                                          std::memory_order_acq_rel)) {
      if (ok) {
        nat_counter_add(NS_CLIENT_RESPONSES, 1);
        uint64_t now = nat_now_ns();
        if (pc->start_ns != 0) {
          nat_lat_record(NL_CLIENT, now - pc->start_ns);
        }
        if (pc->span_sampled) {
          // the caller still owns pc here (the CAS handed it to us), so
          // the span fields are stable; error/status details land after
          // take_pending, so the client span records the round trip only
          NatSpanRec rec;
          memset(&rec, 0, sizeof(rec));
          rec.trace_id = pc->trace_id;
          rec.span_id = pc->span_id;
          rec.parent_span_id = pc->parent_span_id;
          rec.recv_ns = pc->start_ns;
          rec.parse_ns = pc->start_ns;
          rec.dispatch_ns = now;
          rec.write_ns = now;
          rec.protocol = NL_CLIENT;
          size_t n = pc->span_method_len;
          memcpy(rec.method, pc->span_method, n);
          rec.method[n] = '\0';
          nat_span_submit(rec);
        }
        // breaker verdict + retry-budget replenish are fed by the
        // protocol layers (messenger / client-lane finishers), which
        // inspect the response's ACTUAL status — a transport-level
        // "ok" here may still be a server error frame / 5xx / grpc 8
      } else {
        nat_counter_add(NS_CLIENT_ERRORS, 1);
        if (!planned &&
            breaker_enabled.load(std::memory_order_relaxed)) {
          breaker_on_call_end(false);
        }
      }
      return pc;
    }
    return nullptr;
  }

  // Retry-budget replenish: +1 deci-token per success, capped. At the
  // cap (steady state) this is one relaxed load, no RMW.
  void note_call_success() {
    int v = retry_budget_decis.load(std::memory_order_relaxed);
    while (v < kRetryBudgetCap &&
           !retry_budget_decis.compare_exchange_weak(
               v, v + 1, std::memory_order_relaxed)) {
    }
  }

  // Circuit-breaker surface (nat_channel.cpp): feed one finished call;
  // a trip fails the socket and arms the health-check revival chain.
  void breaker_on_call_end(bool call_ok);
  void breaker_reset(bool revived);

  void fail_all(int32_t code, const char* text) {
    uint32_t n = nslots_.load(std::memory_order_acquire);
    for (uint32_t idx = 0; idx < n; idx++) {
      PendingCall* pc = slot_at(idx);
      uint64_t st = pc->state.load(std::memory_order_acquire);
      if (!(st & 1)) continue;
      if (!pc->state.compare_exchange_strong(st, st & ~1ull,
                                             std::memory_order_acq_rel)) {
        continue;  // a response beat us to it
      }
      nat_counter_add(NS_CLIENT_ERRORS, 1);
      // every swept call is an error sample for the breaker (brpc feeds
      // OnCallEnd from socket sweeps too); a trip from here re-enters
      // set_failed, which is idempotent via its failed.exchange
      if (breaker_enabled.load(std::memory_order_relaxed)) {
        breaker_on_call_end(false);
      }
      pc->error_code = code;
      pc->error_text = text;
      if (pc->cb != nullptr) {
        pc->cb(pc, pc->cb_arg);  // cb owns pc
        continue;
      }
      pc->done.value.store(1, std::memory_order_release);
      Scheduler::butex_wake(&pc->done, INT32_MAX);
    }
  }

  void release_slot(uint32_t idx) { push_free(idx); }

 private:
  std::atomic<PendingCall*> slabs_[kMaxSlabs] = {};
  std::atomic<uint32_t> nslots_{0};
  std::atomic<uint64_t> free_head_{0};  // (aba_tag<<32) | (idx+1)
  NatMutex<kLockRankChanGrow> grow_mu_;
  // Consumer-side cache: pop_free grabs the WHOLE free chain in one
  // exchange and walks it privately, so steady-state allocation costs no
  // CAS at all (completions still CAS-push). pop_cache_lock_ arbitrates
  // the rare case of concurrent begin_call callers — losers fall back to
  // the shared-head CAS pop.
  std::atomic<bool> pop_cache_lock_{false};
  uint32_t pop_cache_ = 0;  // encoded idx+1 chain head; under the lock

  uint32_t pop_free() {
    if (!pop_cache_lock_.exchange(true, std::memory_order_acquire)) {
      uint32_t idx = UINT32_MAX;
      if (pop_cache_ == 0) {
        // refill: take the entire shared chain in one exchange
        uint64_t head = free_head_.exchange(0, std::memory_order_acq_rel);
        pop_cache_ = (uint32_t)head;
      }
      if (pop_cache_ != 0) {
        idx = pop_cache_ - 1;
        pop_cache_ = slot_at(idx)->next_free;
      }
      pop_cache_lock_.store(false, std::memory_order_release);
      if (idx != UINT32_MAX) return idx;
      if (!grow()) return UINT32_MAX;
      return pop_free();
    }
    while (true) {
      uint64_t head = free_head_.load(std::memory_order_acquire);
      while ((uint32_t)head != 0) {
        uint32_t idx = (uint32_t)head - 1;
        uint32_t next = slot_at(idx)->next_free;
        uint64_t nhead = ((head >> 32) + 1) << 32 | next;
        if (free_head_.compare_exchange_weak(head, nhead,
                                             std::memory_order_acq_rel)) {
          return idx;
        }
      }
      if (!grow()) return UINT32_MAX;
    }
  }

  void push_free(uint32_t idx) {
    PendingCall* pc = slot_at(idx);
    uint64_t head = free_head_.load(std::memory_order_acquire);
    while (true) {
      pc->next_free = (uint32_t)head;
      uint64_t nhead = ((head >> 32) + 1) << 32 | (idx + 1);
      if (free_head_.compare_exchange_weak(head, nhead,
                                           std::memory_order_acq_rel)) {
        return;
      }
    }
  }

  bool grow() {
    std::lock_guard g(grow_mu_);
    uint32_t n = nslots_.load(std::memory_order_acquire);
    if ((uint32_t)free_head_.load(std::memory_order_acquire) != 0) {
      return true;  // another thread grew while we waited
    }
    uint32_t slab_i = n >> kSlabBits;
    if (slab_i >= kMaxSlabs) return false;
    PendingCall* slab = new PendingCall[kSlabSize];
    NAT_RES_ALLOC(NR_CLUSTER, kSlabSize * sizeof(PendingCall), slab);
    slabs_[slab_i].store(slab, std::memory_order_release);
    nslots_.store(n + kSlabSize, std::memory_order_release);
    // seed indices [n+1, n+kSlabSize) through the freelist; hand out n
    // implicitly by pushing it too
    for (uint32_t i = 0; i < kSlabSize; i++) push_free(n + i);
    return true;
  }
};

// channel internals shared across nat_channel.cpp / nat_client.cpp /
// nat_bench.cpp
int dial_nonblocking(const char* ip, int port, int timeout_ms);
NatSocket* channel_socket(NatChannel* ch, int max_dial_ms = 0);
void health_check_fire(void* raw);
void arm_call_timeout(NatChannel* ch, int64_t cid, int timeout_ms);

// ---------------------------------------------------------------------------
// Messenger seam (nat_messenger.cpp)
// ---------------------------------------------------------------------------

// Large stream payloads fill their request buffer directly from the
// socket/ring (in_buf bypass); frames at least this big use it.
inline constexpr size_t kStreamFillMin = 64u << 10;
size_t stream_fill_feed(NatSocket* s, const char* data, size_t n);

void build_response_frame(IOBuf* out, int64_t cid, int32_t error_code,
                          const std::string& error_text, IOBuf&& payload,
                          IOBuf&& attachment);
void build_request_frame(IOBuf* out, int64_t cid, const std::string& service,
                         const std::string& method, const char* payload,
                         size_t payload_len, const char* att, size_t att_len,
                         uint64_t trace_id = 0, uint64_t span_id = 0);
// zero-copy build: the attachment's refs splice into the frame (no
// payload memcpy; user blocks ride straight into writev)
void build_request_frame_iobuf(IOBuf* out, int64_t cid,
                               const std::string& service,
                               const std::string& method,
                               IOBuf&& attachment, uint64_t trace_id = 0,
                               uint64_t span_id = 0);
bool process_input(NatSocket* s, IOBuf* defer_out = nullptr);
bool drain_socket_inline(NatSocket* s);
// tpu_std bulk-frame fill mode (nat_messenger.cpp): frames with a body
// >= kBulkFillMin read their remaining payload straight into one pooled
// bulk slab (iob_bulk_acquire) consumed as a single IOBuf user block.
inline constexpr size_t kBulkFillMin = 128u << 10;
// Feed freshly-received bytes into the armed fill; returns the count
// consumed (the rest belongs to the next frame). Reading thread only.
size_t bulk_fill_feed(NatSocket* s, const char* data, size_t n);
// Teardown: release a half-filled slab back to the pool.
void bulk_fill_abort(NatSocket* s);

// Native HTTP/1.1 session (nat_http.cpp).
// try_process returns: 1 = session active (consumed what it could),
// 2 = sniff needs more bytes, 0 = not HTTP / protocol error.
int http_try_process(NatSocket* s, IOBuf* batch_out);
void http_round_end(NatSocket* s);
void http_session_free(HttpSessionN* h);
// Zero-copy variant of nat_http_respond: `data` is the complete serialized
// response, possibly carried by arena-backed user blocks (the shm drainer's
// large-payload path) — the reorder window parks the IOBuf itself and the
// socket writev consumes the refs without copying.
int http_respond_iobuf(uint64_t sock_id, int64_t seq, IOBuf&& data,
                       int close_after);
// Sniff a few leading bytes: 1 = HTTP verb, 2 = could become one (need
// more bytes), 0 = definitely not HTTP.
int http_sniff(const char* p, size_t n);
// Native h2/gRPC session (nat_h2.cpp); same conventions.
int h2_try_process(NatSocket* s, IOBuf* batch_out);
void h2_session_free(H2SessionN* h);
int h2_sniff(const char* p, size_t n);
// Static-table HPACK encode primitives (stateless; used by the h2
// response framer and the bench client).
void hp_enc_int(std::string* out, uint64_t v, int prefix, uint8_t first);
void hp_enc_str(std::string* out, std::string_view s);
void hp_enc_header(std::string* out, std::string_view name,
                   std::string_view value);

// Native Redis lane (nat_redis.cpp): RESP parse + ordered replies +
// native store / kind-6 py dispatch.
int redis_try_process(NatSocket* s, IOBuf* batch_out);
void redis_round_end(NatSocket* s);
void redis_session_free(RedisSessN* h);
void redis_store_free(RedisStoreN* st);
RedisStoreN* redis_store_new();
int redis_sniff(const char* p, size_t n);

// Native client protocol lanes (nat_client.cpp): HTTP/1.1 and h2/gRPC
// request framing + response parsing for channel-owned sockets.
// *_process conventions mirror the server lanes: 1 = consumed what it
// could, 0 = protocol error (socket dies).
int http_client_process(NatSocket* s);
int h2_client_process(NatSocket* s, IOBuf* batch_out);
// EOF hook for read-until-close response bodies (HTTP/1.0 / Connection:
// close with no framing): called by set_failed BEFORE fail_all so the
// FIFO-head call completes successfully with the accumulated body.
void http_cli_on_socket_fail(NatSocket* s);
void http_cli_free(HttpCliSessN* c);
void h2_cli_free(H2CliSessN* c);
// Fail ONLY the pending calls whose streams still ride this socket's h2
// client session (used when a GOAWAY-drained socket dies after the
// channel has already moved to a replacement — a channel-wide fail_all
// would spuriously kill calls in flight on the new socket).
void h2c_fail_own_streams(NatSocket* s, int32_t code, const char* text);
// HTTP twin for a detached (lame-duck drained) http client socket:
// complete the pipeline FIFO's remaining calls as planned errors.
void http_cli_fail_own(NatSocket* s, int32_t code, const char* text,
                       bool teardown = false);
// Teardown variant (try_lock sweep): for set_failed when the scheduler
// is stopped and no sweep fiber can run.
void h2c_fail_own_streams_teardown(NatSocket* s, int32_t code,
                                   const char* text);
// Attach the channel's protocol session to a (re)dialed socket; for h2
// this also queues the connection preface + SETTINGS.
void channel_attach_client_session(NatChannel* ch, NatSocket* s);

// h2 shared primitives (implemented in nat_h2.cpp, reused by the client
// lane): frame header emitter and an opaque stateful HPACK decoder.
void h2_frame_header(std::string* out, size_t len, uint8_t type,
                     uint8_t flags, uint32_t sid);
void* hpack_decoder_new();
bool hpack_decoder_decode(void* dec, const uint8_t* d, size_t n,
                          std::string* flat, std::string* path);
void hpack_decoder_free(void* dec);

// Native TLS session (nat_ssl.cpp).
bool ssl_accept_begin(NatSocket* s);
bool ssl_feed(NatSocket* s, const char* data, size_t n);
bool ssl_encrypt(NatSocket* s, IOBuf&& plain, IOBuf* cipher_out);
int ssl_encrypt_and_write(NatSocket* s, IOBuf&& plain);
void ssl_session_free(SslSessionN* s);

// The full extern "C" surface (response emitters the shm drainer reuses,
// channel open/call paths the bench harness shares, the nat_acall*_cb
// typedefs) lives in nat_api.h, included at the top of this header.

}  // namespace brpc_tpu
