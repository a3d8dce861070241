// Dispatcher loops + NatServer lifecycle + the Python-lane C API.
//
// Dispatcher ⇔ EventDispatcher (event_dispatcher_epoll.cpp:249): one epoll
// loop, edge-triggered; reads are drained INLINE on the loop (see
// nat_messenger.cpp); EPOLLOUT wakes the socket's KeepWrite butex.
// NatServer ⇔ brpc::Server + Acceptor (server.cpp): native method registry
// dispatched on fibers/IOBuf, plus a Python lane — a condvar MPSC queue
// Python worker threads drain via ctypes (nat_take_request/nat_respond),
// so arbitrary Python services mount the native port while Python user
// code runs on pthreads, never on fiber stacks.
#include "nat_internal.h"

namespace brpc_tpu {

NatServer::~NatServer() {
  // stop() drains py_q, but a raw-mode socket failing AFTER stop still
  // enqueues its kind-2 close notice; free whatever is left.
  for (PyRequest* r : py_q) delete r;
  if (redis_store != nullptr) redis_store_free(redis_store);
}

// ---------------------------------------------------------------------------
// Dispatcher
// ---------------------------------------------------------------------------

int Dispatcher::start() {
  epfd = epoll_create1(0);
  if (epfd < 0) return -1;
  wake_fd = eventfd(0, EFD_NONBLOCK);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u64 = (uint64_t)-1;
  epoll_ctl(epfd, EPOLL_CTL_ADD, wake_fd, &ev);
  thread = std::thread([this] { run(); });
  return 0;
}

void Dispatcher::shutdown() {
  stop = true;
  uint64_t one = 1;
  ssize_t rc = ::write(wake_fd, &one, 8);
  (void)rc;
  if (thread.joinable()) thread.join();
  {
    // the loop is gone: close anything it never got to
    std::lock_guard g(pend_close_mu);
    for (int fd : pend_close_fds) ::close(fd);
    pend_close_fds.clear();
  }
  ::close(wake_fd);
  ::close(epfd);
}

void Dispatcher::add_consumer(NatSocket* s) {
  struct epoll_event ev;
  ev.events = EPOLLIN | EPOLLET;
  ev.data.u64 = s->id;
  s->epoll_events = ev.events;
  epoll_ctl(epfd, EPOLL_CTL_ADD, s->fd, &ev);
}

void Dispatcher::add_listener(int fd, NatServer* srv) {
  {
    std::lock_guard g(listen_mu);
    listeners[fd] = srv;
  }
  struct epoll_event ev;
  ev.events = EPOLLIN;
  // Listener tags stay below 2^32; socket ids are version<<32|idx with
  // version >= 1, so the two ranges can never collide.
  ev.data.u64 = (uint64_t)fd;
  epoll_ctl(epfd, EPOLL_CTL_ADD, fd, &ev);
}

// Teardown-race-safe listener removal: unregister from epoll + the
// listener map on the caller thread, but defer the CLOSE to the loop
// thread — the loop may be inside accept_loop(fd) right now, and a
// caller-side close would let the fd number be recycled under that
// accept (a connect-flood during stop could then accept on a stranger's
// fd). run() closes parked fds at the top of its next round, after any
// in-flight accept burst on this loop has returned.
void Dispatcher::remove_listener(int fd) {
  {
    std::lock_guard g(listen_mu);
    if (listeners.erase(fd) == 0) return;  // already removed
  }
  epoll_ctl(epfd, EPOLL_CTL_DEL, fd, nullptr);
  if (stop.load(std::memory_order_acquire) || !thread.joinable()) {
    ::close(fd);  // loop gone: no accept can race; close inline
    return;
  }
  {
    std::lock_guard g(pend_close_mu);
    pend_close_fds.push_back(fd);
  }
  uint64_t one = 1;
  ssize_t rc = ::write(wake_fd, &one, 8);  // prompt close, not next 100ms
  (void)rc;
}

void Dispatcher::accept_loop(int lfd, NatServer* srv) {
  while (true) {
    // natfault accept site: err breaks this accept burst (the next
    // EPOLLIN retries), delay stalls the loop before accept4 — widening
    // the accept-vs-teardown window the deferred close protects.
    NatFaultAct faa = NAT_FAULT_POINT(NF_ACCEPT);
    if (faa.action == NF_DELAY) nat_fault_delay_ms(faa.delay_ms);
    if (faa.action == NF_ERR) break;
    int cfd = accept4(lfd, nullptr, nullptr, SOCK_NONBLOCK);
    if (cfd < 0) break;
    int one = 1;
    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    NatSocket* s = sock_create();  // holds the initial reference
    if (s == nullptr) {
      ::close(cfd);
      break;
    }
    s->fd = cfd;
    sock_set_peer_fd(s);  // the /connections remote_side column
    s->disp = pick_dispatcher();  // shard across the loop pool
    s->disp->sockets_owned.fetch_add(1, std::memory_order_relaxed);
    s->server = srv;
    NAT_REF_ACQUIRE(srv, srv.sock);  // NatSocket::release drops it
    srv->connections.fetch_add(1, std::memory_order_relaxed);
    nat_counter_add(NS_CONNECTIONS_ACCEPTED, 1);
    s->conn_visible.store(true, std::memory_order_release);
    if (try_ring_adopt(s)) continue;  // the ring owns this read path
    s->disp->add_consumer(s);
  }
}

void Dispatcher::run() {
  std::vector<struct epoll_event> events(256);
  std::vector<NatSocket*> flush_list;  // drain roles held; flushed per round
  std::vector<Fiber*> wake_batch;      // fibers readied this round
  while (!stop.load(std::memory_order_acquire)) {
    int n = epoll_wait(epfd, events.data(), (int)events.size(), 100);
    // deferred listener closes (remove_listener): the fds were already
    // removed from epoll and the listener map, and any accept_loop on
    // them ran on THIS thread in an earlier round — closing here can
    // never race an accept
    {
      std::lock_guard g(pend_close_mu);
      for (int fd : pend_close_fds) ::close(fd);
      pend_close_fds.clear();
    }
    if (n > 0) {
      // one event-delivering round: the per-loop gauge row and the
      // aggregate counter move together (the stats test relies on it)
      wakeups.fetch_add(1, std::memory_order_relaxed);
      nat_counter_add(NS_DISP_WAKEUPS, 1);
    }
    // every butex wake / spawn from this round coalesces into one
    // remote-queue push + one signal per worker (not per completion)
    Scheduler::instance()->arm_wake_batch(&wake_batch);
    for (int i = 0; i < n; i++) {
      uint64_t data = events[i].data.u64;
      if (data == (uint64_t)-1) {  // wake eventfd
        uint64_t drain;
        ssize_t rc = ::read(wake_fd, &drain, 8);
        (void)rc;
        continue;
      }
      if (data < (1ull << 32)) {  // listener (socket ids are >= 2^32)
        int lfd = (int)data;
        NatServer* srv;
        {
          std::lock_guard g(listen_mu);
          auto it = listeners.find(lfd);
          srv = (it == listeners.end()) ? nullptr : it->second;
          // ref taken UNDER the lock: a racing server_stop erases the
          // listener then releases its registration reference — without
          // this, accept_loop could run on a freed server
          if (srv != nullptr) NAT_REF_ACQUIRE(srv, srv.accept);
        }
        if (srv != nullptr) {
          accept_loop(lfd, srv);
          NAT_REF_RELEASE(srv, srv.accept);
        }
        continue;
      }
      NatSocket* s = sock_address(data);
      if (s == nullptr) continue;
      // sock.borrow held through this round (the flush_list keeps it
      // across the end-of-round writev batch)
      if (events[i].events & EPOLLOUT) {
        s->epollout.value.fetch_add(1, std::memory_order_release);
        Scheduler::butex_wake(&s->epollout, INT32_MAX);
      }
      if (events[i].events & (EPOLLIN | EPOLLHUP | EPOLLERR)) {
        if (drain_socket_inline(s)) {
          flush_list.push_back(s);  // keep the ref until the flush below
          continue;
        }
      }
      NAT_REF_RELEASE(s, sock.borrow);
    }
    // End-of-round flush: one writev per socket covering every burst the
    // round produced (cross-burst syscall batching). The drain role was
    // acquired by drain_socket_inline's push — this loop is its
    // continuation; EAGAIN leftovers ride a KeepWrite fiber.
    for (NatSocket* s : flush_list) {
      if (!s->flush_chain()) {
        NAT_REF_ACQUIRE(s, sock.keepwrite);
        Scheduler::instance()->spawn_detached(keep_write_fiber, s);
      }
      NAT_REF_RELEASE(s, sock.borrow);
    }
    flush_list.clear();
    Scheduler::instance()->flush_wake_batch();
  }
}

// ---------------------------------------------------------------------------
// runtime bring-up + server lifecycle C API
// ---------------------------------------------------------------------------

// Dispatcher pool (-event_dispatcher_num analog, event_dispatcher.cpp:30):
// sockets are sharded round-robin across N independent epoll loops so the
// inline read/process path scales past one core. Listeners live on
// loop 0; accepted/connected sockets go to the next loop in turn.
// natcheck:leak(nat_rpc_server_start): dispatcher/worker threads run
// through exit() and pick_dispatcher() must never read a destructed
// vector (the bench-exit SIGSEGV class, BENCH_r05 rc 139).
std::vector<Dispatcher*>& g_disps = *new std::vector<Dispatcher*>();
Dispatcher* g_disp = nullptr;  // g_disps[0]: listeners + console
NatServer* g_rpc_server = nullptr;
NatMutex<kLockRankRuntime> g_rt_mu;
static std::atomic<uint32_t> g_disp_rr{0};
static std::atomic<uint32_t> g_disp_rr_cli{0};
static int g_disp_count = 0;  // 0 = auto (set before first runtime use)

// Dispatcher split (NAT_DISP_SPLIT=1): accepted sockets round-robin over
// the even loop indices, dialed (client) sockets over the odd ones — an
// IN-PROCESS loopback bench then stops multiplexing both runtimes' hot
// sockets through one loop (the cross-runtime interference the
// single-core bench numbers used to include; bench.py sets it for its
// in-process lanes). Default OFF: a dedicated server or client process
// must shard over the WHOLE pool — partitioning there would idle half
// the loops (measured: a 2-loop server process lost ~30% at 2 cpus).
static std::atomic<int> g_disp_split{-1};  // -1 = unread

Dispatcher* pick_dispatcher(bool client_side) {
  size_t n = g_disps.size();
  if (n == 1) return g_disps[0];
  int split = g_disp_split.load(std::memory_order_relaxed);
  if (split < 0) {
    const char* env = getenv("NAT_DISP_SPLIT");
    split = (env != nullptr && env[0] == '1') ? 1 : 0;
    g_disp_split.store(split, std::memory_order_relaxed);
  }
  if (split == 1) {
    if (client_side) {
      uint32_t i = g_disp_rr_cli.fetch_add(1, std::memory_order_relaxed);
      return g_disps[1 + 2 * (i % (n / 2))];
    }
    uint32_t i = g_disp_rr.fetch_add(1, std::memory_order_relaxed);
    return g_disps[2 * (i % ((n + 1) / 2))];
  }
  // unsplit: independent round-robin per side over the whole pool
  uint32_t i = client_side
                   ? g_disp_rr_cli.fetch_add(1, std::memory_order_relaxed)
                   : g_disp_rr.fetch_add(1, std::memory_order_relaxed);
  return g_disps[i % n];
}

int ensure_runtime(int nworkers) {
  std::lock_guard g(g_rt_mu);
  if (!Scheduler::instance()->started()) {
    if (nworkers <= 0) {
      unsigned hw = std::thread::hardware_concurrency();
      nworkers = hw > 1 ? (int)hw : 1;
      if (nworkers > 16) nworkers = 16;  // brpc-class default; beyond
      // this the random-steal idle loops cost more than they serve
    }
    Scheduler::instance()->start(nworkers);
  }
  if (g_disps.empty()) {
    int n = g_disp_count;
    if (n <= 0) {
      // NAT_DISPATCHERS overrides; default = min(cores, 4) — the
      // event_dispatcher_num sweet spot: one epoll/io_uring loop per
      // core up to the point where loops start stealing usercode time
      const char* env = getenv("NAT_DISPATCHERS");
      if (env != nullptr && env[0] != '\0') n = atoi(env);
      if (n <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        n = hw >= 1 ? (int)hw : 1;
        if (n > 4) n = 4;
      }
    }
    for (int i = 0; i < n; i++) {
      Dispatcher* d = new Dispatcher();
      d->idx = i;
      if (d->start() != 0) {
        delete d;
        if (g_disps.empty()) return -1;
        break;  // run with what we have
      }
      g_disps.push_back(d);
    }
    g_disp = g_disps[0];
  }
  return 0;
}

// Bound listen socket for a server port. A stop/quiesce DEFERS the old
// listener fd's close to its dispatcher loop thread (the accept-vs-
// teardown race fix), so an immediate restart on the SAME port can
// land in the window before the loop runs — SO_REUSEADDR does not
// cover a still-open listener. Binding a specific port therefore
// retries EADDRINUSE briefly (the window is one loop wakeup, normally
// microseconds; 500ms bounds a stalled loop). Returns the fd or -1.
static int server_listen_fd(const char* ip, int port) {
  for (int attempt = 0;; attempt++) {
    int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    struct sockaddr_in addr;
    memset(&addr, 0, sizeof(addr));
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, ip, &addr.sin_addr);
    if (bind(fd, (struct sockaddr*)&addr, sizeof(addr)) == 0 &&
        listen(fd, 1024) == 0) {
      return fd;
    }
    int err = errno;
    ::close(fd);
    if (port == 0 || err != EADDRINUSE || attempt >= 100) return -1;
    struct timespec ts = {0, 5 * 1000 * 1000};
    nanosleep(&ts, nullptr);
  }
}

// Tear down every extra listener (nat_rpc_server_add_port) — server
// stop/quiesce. Caller holds g_rt_mu.
void server_remove_extra_ports_locked(NatServer* srv) {
  for (auto& kv : srv->extra_ports) {
    kv.second.second->remove_listener(kv.second.first);
  }
  srv->extra_ports.clear();
}

extern "C" {

// -event_dispatcher_num analog: set the epoll-loop pool size BEFORE the
// runtime starts (0 = auto from hardware_concurrency). Returns the count
// in effect.
int nat_rpc_set_dispatchers(int n) {
  std::lock_guard g(g_rt_mu);
  if (g_disps.empty() && n >= 0) g_disp_count = n;
  return g_disps.empty() ? g_disp_count : (int)g_disps.size();
}

// PassiveStatus-style gauge (nat_stats): depth of the running server's
// py-lane queue at snapshot time. Called only from the stats C API with
// no runtime locks held.
static uint64_t py_queue_depth_gauge() {
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return 0;
  std::lock_guard g2(srv->py_mu);
  return (uint64_t)srv->py_q.size();
}

// Start the native RPC server. enable_native_echo registers the built-in
// EchoService.Echo handler (zero-copy: response payload/attachment share
// the request's IOBuf blocks). Python services ride the py lane.
int nat_rpc_server_start(const char* ip, int port, int nworkers,
                         int enable_native_echo) {
  {
    std::lock_guard g(g_rt_mu);
    if (g_rpc_server != nullptr) return -1;
  }
  if (ensure_runtime(nworkers) != 0) return -1;
  nat_stats_register_gauge(NS_PY_QUEUE_DEPTH, py_queue_depth_gauge);
  overload_server_reset();  // stale admission tokens die with the old
                            // server; the limiter config itself persists
  g_draining.store(0, std::memory_order_release);  // fresh server serves
  int fd = server_listen_fd(ip, port);
  if (fd < 0) return -1;
  struct sockaddr_in addr;
  socklen_t alen = sizeof(addr);
  getsockname(fd, (struct sockaddr*)&addr, &alen);

  NatServer* srv = new NatServer();
  NAT_REF_ACQUIRED(srv, srv.registry);  // ref{1} = the registration
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  srv->disp = g_disp;
  srv->py_lane_enabled = true;
  if (enable_native_echo) {
    srv->handlers["EchoService.Echo"] = [](NativeHandlerCtx& ctx) {
      // echo: hand the request blocks straight back (no copy)
      ctx.resp_payload.append(std::move(*ctx.req_payload));
      ctx.resp_attachment.append(std::move(*ctx.req_attachment));
    };
    // the native-usercode HTTP twin (builtin-service discipline): POST
    // body echoes back, GET answers a constant — the bench lane for
    // native-parse + native-usercode HTTP
    srv->http_handlers["/echo"] = [](HttpHandlerCtxN& ctx) {
      if (ctx.body.empty()) {
        ctx.resp_body.append("pong", 4);
      } else {
        ctx.resp_body.append(ctx.body.data(), ctx.body.size());
      }
      ctx.content_type = "application/octet-stream";
    };
  }
  // builtin.stats: the wire-native observability endpoint (always on,
  // the builtin-service discipline). One tpu_std call returns the
  // versioned snapshot JSON — counters, per-method raw log2 buckets,
  // overload/quiesce and channel breaker state, the nat_res ledger — so
  // a fleet collector scrapes over the same RPC lane it load-balances,
  // with no Python on the serving side. Runs inline in the reader fiber:
  // the builder takes no blocking lock beyond the channel-registry leaf.
  srv->handlers["builtin.stats"] = [](NativeHandlerCtx& ctx) {
    char* buf = nullptr;
    size_t len = 0;
    if (nat_stats_snapshot(&buf, &len) != 0) {
      ctx.error_code = kEREQUEST;  // snapshot malloc failed (~never)
      ctx.error_text = "snapshot build failed";
      return;
    }
    ctx.resp_payload.append(buf, len);
    free(buf);
  };
  srv->freeze_handlers();
  {
    // publish AND register the listener in ONE critical section: a
    // concurrent stop can then never observe the published server while
    // missing its listener registration (ADVICE r3 #2)
    std::lock_guard g(g_rt_mu);
    if (g_rpc_server != nullptr) {  // lost a concurrent-start race
      ::close(fd);
      NAT_REF_RELEASE(srv, srv.registry);
      return -1;
    }
    g_rpc_server = srv;
    g_disp->add_listener(fd, srv);
  }
  return srv->port;
}

void nat_rpc_server_stop() {
  NatServer* srv;
  {
    std::lock_guard g(g_rt_mu);
    srv = g_rpc_server;
    if (srv == nullptr) return;
    g_rpc_server = nullptr;
    // remove the listener in the same critical section that unpublishes
    // (the start path registers under g_rt_mu too, so no listener of a
    // published server can be missed here). The fd CLOSE is deferred to
    // the loop thread — see Dispatcher::remove_listener. A preceding
    // nat_server_quiesce already tore the listener down (listen_fd -1).
    if (srv->listen_fd >= 0) {
      g_disp->remove_listener(srv->listen_fd);
      srv->listen_fd = -1;
    }
    server_remove_extra_ports_locked(srv);
  }
  g_draining.store(0, std::memory_order_release);
  // stop the python lane (wakes all waiters empty-handed)
  {
    std::lock_guard g(srv->py_mu);
    srv->py_stopping = true;
  }
  srv->py_cv.notify_all();
  // fail remaining server-side connections: scan the slot space (bounded
  // by the high-water mark) and take a safe reference before failing
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
    if (s->server == srv) s->set_failed();
    NAT_REF_RELEASE(s, sock.borrow);
  }
  // drain queued python-lane requests under the lane lock
  {
    std::lock_guard g(srv->py_mu);
    for (PyRequest* r : srv->py_q) delete r;
    srv->py_q.clear();
  }
  // sockets/takers may still hold their references — the last deletes
  NAT_REF_RELEASE(srv, srv.registry);
}

// Multi-port listening (the swarm-backend seam): bind+listen another
// port for the RUNNING server and shard the listener across the
// dispatcher pool — 250 ports on a 4-loop runtime accept on 4 loops
// instead of serializing through loop 0. Returns the bound port.
int nat_rpc_server_add_port(const char* ip, int port) {
  int fd = server_listen_fd(ip, port);
  if (fd < 0) return -1;
  struct sockaddr_in addr;
  socklen_t alen = sizeof(addr);
  getsockname(fd, (struct sockaddr*)&addr, &alen);
  int bound = ntohs(addr.sin_port);
  {
    std::lock_guard g(g_rt_mu);
    NatServer* srv = g_rpc_server;
    if (srv == nullptr || srv->listen_fd < 0 ||
        srv->extra_ports.count(bound) != 0) {
      ::close(fd);  // no server / draining teardown / duplicate port
      return -1;
    }
    Dispatcher* d = pick_dispatcher();
    srv->extra_ports[bound] = {fd, d};
    d->add_listener(fd, srv);
  }
  return bound;
}

// Unregister one add_port listener (live naming-removal drills close
// the port while accepted connections keep serving). Returns 0, or -1
// when the port was not an extra listener of the running server.
int nat_rpc_server_remove_port(int port) {
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return -1;
  auto it = srv->extra_ports.find(port);
  if (it == srv->extra_ports.end()) return -1;
  it->second.second->remove_listener(it->second.first);
  srv->extra_ports.erase(it);
  return 0;
}

// Enable the multi-protocol raw fallback on the running server: framing
// the native cut loop doesn't recognize is handed to the Python protocol
// stack as ordered raw chunks instead of failing the socket. Call right
// after nat_rpc_server_start, before clients connect.
int nat_rpc_server_enable_raw_fallback(int enable) {
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return -1;
  srv->raw_fallback = (enable != 0);
  return 0;
}

// Enable native HTTP/1.1 + h2/gRPC parsing on the running server:
// HTTP-shaped connections are parsed in the native cut loop and delivered
// to the py lane as kind-3/kind-4 requests (parse native, execute Python)
// instead of riding the raw chunk lane. Call right after start.
int nat_rpc_server_native_http(int enable) {
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return -1;
  srv->native_http = (enable != 0);
  return 0;
}

// Enable the native Redis lane (policy/redis_protocol.cpp role):
// mode 1 = RESP parsed natively, commands dispatched to the Python
// RedisService as kind-6 requests; mode 2 = additionally execute the
// GET/SET command family against a native in-memory store (unknown
// commands still reach the Python handlers). Call right after start.
int nat_rpc_server_redis(int mode) {
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return -1;
  srv->native_redis = mode;
  if (mode == 2 && srv->redis_store == nullptr) {
    srv->redis_store = redis_store_new();
  }
  return 0;
}

int32_t nat_req_kind(void* h) { return ((PyRequest*)h)->kind; }

uint64_t nat_rpc_server_requests() {
  std::lock_guard g(g_rt_mu);
  return g_rpc_server
             ? g_rpc_server->requests.load(std::memory_order_relaxed)
             : 0;
}

uint64_t nat_rpc_server_connections() {
  std::lock_guard g(g_rt_mu);
  return g_rpc_server
             ? g_rpc_server->connections.load(std::memory_order_relaxed)
             : 0;
}

// ---- Python lane (usercode on pthreads) ----

void* nat_take_request(int timeout_ms) {
  NatServer* srv;
  {
    std::lock_guard g(g_rt_mu);
    srv = g_rpc_server;
    if (srv == nullptr) return nullptr;
    // keeps the server alive across the blocking wait
    NAT_REF_ACQUIRE(srv, srv.taker);
  }
  void* r = srv->take_py(timeout_ms);
  NAT_REF_RELEASE(srv, srv.taker);
  return r;
}

// Batch variant: fills up to `max` handles, returns the count.
int nat_take_request_batch(void** out, int max, int timeout_ms) {
  NatServer* srv;
  {
    std::lock_guard g(g_rt_mu);
    srv = g_rpc_server;
    if (srv == nullptr) return 0;
    NAT_REF_ACQUIRE(srv, srv.taker);
  }
  int n = srv->take_py_batch((PyRequest**)out, max, timeout_ms);
  NAT_REF_RELEASE(srv, srv.taker);
  return n;
}

const char* nat_req_field(void* h, int which, size_t* len) {
  PyRequest* r = (PyRequest*)h;
  if (r->shm_slot >= 0) {
    // shm descriptor-lane request: fields are views straight into the
    // mapped blob arena (valid until nat_req_free releases the span)
    if (which < 0 || which > 4) {
      *len = 0;
      return nullptr;
    }
    *len = r->shm_view_len[which];
    return r->shm_view[which];
  }
  const std::string* s = nullptr;
  switch (which) {
    case 0: s = &r->service; break;
    case 1: s = &r->method; break;
    case 2:
      if (r->big_payload != nullptr) {  // fill-mode stream payload
        *len = r->big_len;
        return r->big_payload;
      }
      s = &r->payload;
      break;
    case 3: s = &r->attachment; break;
    case 4: s = &r->meta_bytes; break;
    default: *len = 0; return nullptr;
  }
  *len = s->size();
  return s->data();
}

int64_t nat_req_cid(void* h) { return ((PyRequest*)h)->cid; }
uint64_t nat_req_aux(void* h) { return ((PyRequest*)h)->aux; }
int32_t nat_req_compress(void* h) { return ((PyRequest*)h)->compress_type; }
uint64_t nat_req_sock_id(void* h) { return ((PyRequest*)h)->sock_id; }
void nat_req_free(void* h) { delete (PyRequest*)h; }

// Raw write of pre-framed bytes onto a live connection — lets the Python
// protocol layer (send_rpc_response with its full feature set) answer
// py-lane requests through the native Socket write queue.
int nat_sock_write(uint64_t sock_id, const char* data, size_t len) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  IOBuf out;
  out.append(data, len);
  int rc = s->write(std::move(out));
  NAT_REF_RELEASE(s, sock.borrow);
  return rc;
}

int nat_sock_set_failed(uint64_t sock_id) {
  NatSocket* s = sock_address(sock_id);
  if (s == nullptr) return -1;
  s->set_failed();
  NAT_REF_RELEASE(s, sock.borrow);
  return 0;
}

// Respond to a py-lane request and free it. Returns 0, or -1 if the
// connection is gone.
int nat_respond(void* h, int32_t error_code, const char* error_text,
                const char* payload, size_t payload_len, const char* att,
                size_t att_len) {
  PyRequest* r = (PyRequest*)h;
  // error completions must not feed the gradient limiter's latency
  // window as capacity samples (AutoLimiter.on_response's filter)
  if (error_code != 0) r->admit_ok = false;
  NatSocket* s = sock_address(r->sock_id);
  int rc = -1;
  if (s != nullptr) {
    IOBuf out, pay, attach;
    if (payload_len) pay.append(payload, payload_len);
    if (att_len) attach.append(att, att_len);
    build_response_frame(&out, r->cid, error_code,
                         error_text ? error_text : "", std::move(pay),
                         std::move(attach));
    rc = s->write(std::move(out));
    // count only frames accepted for the wire: a failed-socket write
    // must not over-report /connections out_msgs vs the byte counters
    if (rc == 0) s->c_out_msgs.fetch_add(1, std::memory_order_relaxed);
    NAT_REF_RELEASE(s, sock.borrow);
  }
  delete r;
  return rc;
}

// SQPOLL gauge: rings currently running with a kernel SQ poller.
static uint64_t sqpoll_rings_gauge() {
  if (!g_rings_ready.load(std::memory_order_acquire)) return 0;
  uint64_t n = 0;
  for (RingListener* r : g_rings) {
    if (r->sqpoll_active()) n++;
  }
  return n;
}

// Enables the RingListener datapath for subsequently-accepted server
// connections — ONE ring per dispatcher loop, so loops never share an
// SQ (the event_dispatcher_num x io_uring product). Returns 1 when at
// least one ring is live, 0 when the kernel/sandbox refuses io_uring
// (the runtime stays on epoll), -1 on runtime failure.
int nat_rpc_use_io_uring(int enable) {
  if (!enable) {
    g_use_ring.store(false, std::memory_order_release);
    return 0;
  }
  if (ensure_runtime(0) != 0) return -1;
  {
    std::lock_guard g(g_rt_mu);
    if (g_rings.empty()) {
      for (Dispatcher* d : g_disps) {
        RingListener* ring = new RingListener();
        // wake a parked worker per completion batch (ExtWakeup role);
        // installed before init() so the poller never runs without it
        ring->set_wake_fn([] { Scheduler::instance()->wake_one(); });
        // the poller drains its own harvest inline (every completion
        // consumer is non-blocking), with butex wakes batched per drain
        // — the worker idle hook below stays as a backup drain path
        ring->set_drain_fn([ring]() -> bool {
          static thread_local std::vector<Fiber*> batch;
          if (ring->draining.load(std::memory_order_acquire)) {
            return false;  // a worker holds the baton: let the poller
          }                // wake one instead of silently dropping
          Scheduler::instance()->arm_wake_batch(&batch);
          bool did = ring_drain_one(ring);
          Scheduler::instance()->flush_wake_batch();
          return did;
        });
        // natcheck:allow(lock-switch): one-time ring bring-up under the
        // runtime lock (cold path, caller thread); init's failure path
        // joins a poller that never touches g_rt_mu
        if (!ring->init()) {
          delete ring;
          break;  // kernel refuses: later loops would refuse too
        }
        d->ring = ring;
        g_rings.push_back(ring);
      }
      if (g_rings.empty()) return 0;  // io_uring unavailable: keep epoll
      // publish: the vector never mutates again — lock-free readers
      // (ring_drain, counters, gauges, /status) gate on this flag
      g_rings_ready.store(true, std::memory_order_release);
      // the wait_task drain seam (task_group.cpp:158-169)
      Scheduler::instance()->add_idle_hook(ring_drain);
      nat_stats_register_gauge(NS_SQPOLL_RINGS, sqpoll_rings_gauge);
    }
  }
  g_use_ring.store(true, std::memory_order_release);
  return 1;
}

// Ring observability for tests/bench: completion counts over all rings.
void nat_ring_counters(uint64_t* recv_out, uint64_t* send_out) {
  uint64_t recv = 0, send = 0;
  if (g_rings_ready.load(std::memory_order_acquire)) {
    for (RingListener* r : g_rings) {
      recv += r->recv_completions();
      send += r->send_completions();
    }
  }
  if (recv_out != nullptr) *recv_out = recv;
  if (send_out != nullptr) *send_out = send;
}

// ---- multicore observability (per-dispatcher rows in /vars) ----

int nat_disp_count(void) { return (int)g_disps.size(); }

// Per-dispatcher snapshot: connections the loop owns right now, epoll
// rounds that delivered events, and whether its ring runs SQPOLL
// (sqpoll_out: -1 = no ring, 0/1 otherwise).
int nat_disp_stat(int idx, uint64_t* sockets_out, uint64_t* wakeups_out,
                  int* sqpoll_out) {
  if (idx < 0 || (size_t)idx >= g_disps.size()) return -1;
  Dispatcher* d = g_disps[idx];
  if (sockets_out != nullptr) {
    int64_t v = d->sockets_owned.load(std::memory_order_relaxed);
    *sockets_out = v > 0 ? (uint64_t)v : 0;
  }
  if (wakeups_out != nullptr) {
    *wakeups_out = d->wakeups.load(std::memory_order_relaxed);
  }
  if (sqpoll_out != nullptr) {
    // d->ring is written during the one-time ring build; only read it
    // once the build has published (plain pointer otherwise racy)
    RingListener* r = g_rings_ready.load(std::memory_order_acquire)
                          ? d->ring
                          : nullptr;
    *sqpoll_out = r == nullptr ? -1 : r->sqpoll_active() ? 1 : 0;
  }
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
