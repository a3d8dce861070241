// NatSocket + versioned-id registry + the io_uring datapath seam.
//
// This is the native counterpart of brpc::Socket (socket.cpp): a
// versioned-id registry (socket_inl.h:28-185), the WAIT-FREE MPSC write
// stack (socket.h:293-333 — one atomic exchange enqueues, the empty-head
// winner becomes the single drainer; inline writev first attempt,
// leftovers to a KeepWrite fiber), SetFailed handing cleanup to the role
// holder, and the per-dispatcher RingListener fixed-buffer send lane (the
// fork's io_uring discipline).
//
// Drain-role ledger (who continues the drain after each transition):
//   push() == true           the pushing thread (write_raw/wdrive)
//   inline writev EAGAIN     a KeepWrite fiber parked on EPOLLOUT
//   ring send submitted      that send's completion (ring_drain)
//   ring SQE/buffer missing  a g_ring_retry entry (holds a socket ref)
//   socket failed            whoever holds the role: write_release_all
// The role is released ONLY by grab_more's head CAS to nullptr, so
// wstack.empty() is exactly the "all flushed, nobody writing" predicate.
#include "nat_internal.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// registry
// ---------------------------------------------------------------------------

std::atomic<std::atomic<NatSocket*>*> g_sock_slab[kSockSlabs];
NatMutex<kLockRankSockAlloc> g_sock_alloc_mu;
// natcheck:leak(g_sock_free): fibers on detached workers allocate/release
// socket slots through exit(); a destructed free list is a use-after-free.
std::vector<uint32_t>& g_sock_free = *new std::vector<uint32_t>();
uint32_t g_sock_next_idx = 0;

// Allocate (or reuse) a socket slot; the returned socket has refcount 1
// (the registry/creator reference) and a fresh version in both its id and
// its versioned_ref.
NatSocket* sock_create() {
  uint32_t idx;
  NatSocket* s = nullptr;
  {
    std::lock_guard g(g_sock_alloc_mu);
    if (!g_sock_free.empty()) {
      idx = g_sock_free.back();
      g_sock_free.pop_back();
      s = sock_at(idx);
    } else {
      idx = g_sock_next_idx++;
      uint32_t slab_i = idx >> kSockSlabBits;
      if (slab_i >= kSockSlabs) return nullptr;
      if (g_sock_slab[slab_i].load(std::memory_order_relaxed) == nullptr) {
        auto* slab = new std::atomic<NatSocket*>[kSockSlabSize]();
        NAT_RES_ALLOC(NR_SOCK_SLAB,
                      kSockSlabSize * sizeof(std::atomic<NatSocket*>),
                      slab);
        g_sock_slab[slab_i].store(slab, std::memory_order_release);
      }
      // construct + publish while still holding the alloc lock so the
      // hwm-bounded server-stop scan can never see a half-built socket
      // (the slot store is release; sock_at loads acquire)
      // natcheck:leak(sock_create): ResourcePool discipline — sockets
      // and their slabs are never freed; slot indices stay valid forever
      s = new NatSocket();  // lives forever in its slot
      NAT_RES_ALLOC(NR_SOCK_SLAB, sizeof(NatSocket), s);
      g_sock_slab[slab_i].load(std::memory_order_acquire)
          [idx & (kSockSlabSize - 1)]
              .store(s, std::memory_order_release);
      s = nullptr;  // fall through to the common init below
    }
  }
  if (s == nullptr) {
    s = sock_at(idx);
  } else {
    s->reset_for_reuse();
  }
  uint32_t ver = s->next_version++;
  if (ver == 0) ver = s->next_version++;  // version 0 reserved (= dead)
  s->id = ((uint64_t)ver << 32) | idx;
  // the initial refcount IS the creator/registry reference; set_failed
  // retires it after sock_unregister
  NAT_REF_ACQUIRED(s, sock.registry);
  s->versioned_ref.store(((uint64_t)ver << 32) | 1,
                         std::memory_order_release);
  return s;
}

// Address with a borrowed reference (caller must release()); nullptr once
// the id generation is stale — use-after-free-proof, lock-free.
NatSocket* sock_address(uint64_t id) {
  uint32_t idx = (uint32_t)(id & 0xffffffffu);
  uint32_t ver = (uint32_t)(id >> 32);
  NatSocket* s = sock_at(idx);
  if (s == nullptr) return nullptr;
  uint64_t vr = s->versioned_ref.load(std::memory_order_acquire);
  while ((uint32_t)(vr >> 32) == ver && (uint32_t)vr != 0) {
    if (s->versioned_ref.compare_exchange_weak(vr, vr + 1,
                                               std::memory_order_acq_rel)) {
      // the CAS above IS the count change: a sock.borrow the caller
      // must release (the Address/SetFailed discipline's borrow half)
      NAT_REF_ACQUIRED(s, sock.borrow);
      return s;
    }
  }
  return nullptr;
}

// Version-blind pin (nat_conn_snapshot): any nonzero refcount pins the
// slot against recycling; the version is irrelevant because the walker
// starts from the slot, not from an id.
NatSocket* sock_try_pin(NatSocket* s) {
  uint64_t vr = s->versioned_ref.load(std::memory_order_acquire);
  while ((uint32_t)vr != 0) {  // no refs: free / being recycled
    if (s->versioned_ref.compare_exchange_weak(
            vr, vr + 1, std::memory_order_acq_rel)) {
      NAT_REF_ACQUIRED(s, sock.borrow);
      return s;
    }
  }
  return nullptr;
}

// Invalidate the id (bump the version, keeping the refcount) so future
// sock_address calls fail; existing references stay valid until released.
void sock_unregister(NatSocket* s) {
  uint64_t vr = s->versioned_ref.load(std::memory_order_acquire);
  while (true) {
    uint64_t bumped = vr + (1ull << 32);
    if (s->versioned_ref.compare_exchange_weak(vr, bumped,
                                               std::memory_order_acq_rel)) {
      s->next_version = (uint32_t)(bumped >> 32) + 1;
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// WriteReq pool — per-thread freelist (ObjectPool discipline): the per-
// write allocation on the hot path is a TLS pop, and a node freed by the
// drainer on another core re-enters THAT core's cache.
// ---------------------------------------------------------------------------

namespace {
struct WreqCache {
  static const int kCap = 64;
  WriteReq* head = nullptr;
  int n = 0;
  ~WreqCache() {
    while (head != nullptr) {
      WriteReq* next = head->wnext.load(std::memory_order_relaxed);
      NAT_RES_FREE(NR_SOCK_WREQ, sizeof(WriteReq), head);
      delete head;
      head = next;
    }
  }
};
thread_local WreqCache tls_wreq;
}  // namespace

WriteReq* wreq_alloc() {
  WreqCache& c = tls_wreq;
  WriteReq* r;
  if (c.head != nullptr) {
    r = c.head;
    c.head = r->wnext.load(std::memory_order_relaxed);
    c.n--;
  } else {
    r = new WriteReq();
    NAT_RES_ALLOC(NR_SOCK_WREQ, sizeof(WriteReq), r);
  }
  // a live write-stack node until the drainer's wreq_free
  NAT_REF_ACQUIRED(r, wreq.node);
  return r;
}

void wreq_free(WriteReq* r) {
  NAT_REF_RELEASED(r, wreq.node);
  r->data.clear();
  WreqCache& c = tls_wreq;
  if (c.n >= WreqCache::kCap) {
    NAT_RES_FREE(NR_SOCK_WREQ, sizeof(WriteReq), r);
    delete r;
    return;
  }
  r->wnext.store(c.head, std::memory_order_relaxed);
  c.head = r;
  c.n++;
}

// ---------------------------------------------------------------------------
// NatSocket
// ---------------------------------------------------------------------------

// natcheck:leak(g_rings): ring pollers run through exit()
std::vector<RingListener*>& g_rings = *new std::vector<RingListener*>();
// g_rings is built ONCE (under g_rt_mu, only when empty) and never
// mutated again; every lock-free reader gates on this flag (release
// store after the build, acquire loads) so no iteration can race the
// vector's growth reallocations.
std::atomic<bool> g_rings_ready{false};
std::atomic<bool> g_use_ring{false};
static NatMutex<kLockRankRingRetry> g_ring_retry_mu;
// sockets whose parked drain role waits for a free SQE/send buffer; each
// entry holds a socket reference AND the drain role.
// natcheck:leak(g_ring_retry): the ring pollers and workers may still
// push retries while exit() destroys statics.
static std::vector<NatSocket*>& g_ring_retry = *new std::vector<NatSocket*>();

static void ring_retry_park(NatSocket* s) {
  NAT_REF_ACQUIRE(s, sock.ringretry);  // the retry pass inherits the role
  std::lock_guard g(g_ring_retry_mu);
  g_ring_retry.push_back(s);
}

void NatSocket::release() {
  uint64_t prev = versioned_ref.fetch_sub(1, std::memory_order_acq_rel);
  if ((uint32_t)prev == 1) {
    // Deferred close (brpc defers to refcount-zero too, socket.cpp): the
    // fd number is only recycled once no fiber can still syscall on it,
    // so a stale writev can never land on a reused descriptor. The object
    // itself is NEVER freed (ResourcePool discipline) — its slot goes
    // back to the freelist for the next sock_create.
    if (fd >= 0) {
      ::close(fd);
      fd = -1;
    }
    if (channel != nullptr) {
      NAT_REF_RELEASE(channel, chan.sock);
      channel = nullptr;
    }
    if (server != nullptr) {
      NAT_REF_RELEASE(server, srv.sock);
      server = nullptr;
    }
    if (http != nullptr) {
      http_session_free(http);
      http = nullptr;
    }
    if (h2 != nullptr) {
      h2_session_free(h2);
      h2 = nullptr;
    }
    if (ssl_sess != nullptr) {
      ssl_session_free(ssl_sess);
      ssl_sess = nullptr;
    }
    if (redis != nullptr) {
      redis_session_free(redis);
      redis = nullptr;
    }
    if (fill_req != nullptr) {  // connection died mid-payload
      delete fill_req;
      fill_req = nullptr;
      fill_off = 0;
    }
    bulk_fill_abort(this);  // died mid-bulk-frame: slab back to the pool
    if (httpc != nullptr) {
      http_cli_free(httpc);
      httpc = nullptr;
    }
    if (h2c != nullptr) {
      h2_cli_free(h2c);
      h2c = nullptr;
    }
    in_buf.clear();
    // refcount zero: no writer and no drainer can still reference this
    // socket, so any leftover drain state (a failed socket whose role
    // holder already cleaned up leaves none) is safely reclaimed here.
    wbuf.clear();
    NAT_REF_DEAD(this);  // refguard: every tag must balance to zero here
    uint32_t idx = (uint32_t)(id & 0xffffffffu);
    std::lock_guard g(g_sock_alloc_mu);
    g_sock_free.push_back(idx);
  }
}

void NatSocket::reset_for_reuse() {
  fd = -1;
  disp = nullptr;
  server = nullptr;
  channel = nullptr;
  failed.store(false, std::memory_order_relaxed);
  wcur = nullptr;
  wbuf.clear();
  defer_writes = false;
  epoll_events = 0;
  epollout.value.store(0, std::memory_order_relaxed);
  ring_ref.store(-1, std::memory_order_relaxed);
  ring = nullptr;
  ring_sending = false;
  ring_inflight = 0;
  py_raw.store(false, std::memory_order_relaxed);
  py_raw_seq = 0;
  py_streams.store(false, std::memory_order_relaxed);
  stream_seq = 0;
  fill_req = nullptr;
  fill_off = 0;
  bulk_buf = nullptr;
  bulk_cap = 0;
  bulk_len = 0;
  bulk_off = 0;
  http = nullptr;
  h2 = nullptr;
  redis = nullptr;
  httpc = nullptr;
  h2c = nullptr;
  ssl_sess = nullptr;
  ssl_declined = false;
  close_after_drain.store(false, std::memory_order_relaxed);
  spoke_tpu_std.store(false, std::memory_order_relaxed);
  conn_visible.store(false, std::memory_order_relaxed);
  c_in_bytes.store(0, std::memory_order_relaxed);
  c_out_bytes.store(0, std::memory_order_relaxed);
  c_in_msgs.store(0, std::memory_order_relaxed);
  c_out_msgs.store(0, std::memory_order_relaxed);
  c_read_calls.store(0, std::memory_order_relaxed);
  c_write_calls.store(0, std::memory_order_relaxed);
  c_unwritten.store(0, std::memory_order_relaxed);
  c_rdbuf.store(0, std::memory_order_relaxed);
  c_parked.store(0, std::memory_order_relaxed);
  peer[0] = '\0';
}

void sock_set_peer_fd(NatSocket* s) {
  struct sockaddr_in sa;
  socklen_t sl = sizeof(sa);
  if (getpeername(s->fd, (struct sockaddr*)&sa, &sl) != 0 ||
      sa.sin_family != AF_INET) {
    return;
  }
  char ip[INET_ADDRSTRLEN] = {0};
  inet_ntop(AF_INET, &sa.sin_addr, ip, sizeof(ip));
  sock_set_peer(s, ip, (int)ntohs(sa.sin_port));
}

void NatSocket::set_failed() {
  bool was = failed.exchange(true, std::memory_order_seq_cst);
  if (was) return;
  {
    int64_t rr = ring_ref.exchange(-1, std::memory_order_acq_rel);
    if (rr >= 0 && ring != nullptr) {
      ring->unregister_file((int)(rr & 0xffffffff));  // cancels recv
    }
  }
  // Queued writes are NOT touched here: the drain role holder (inline
  // writer, KeepWrite fiber, ring completion, retry entry) observes
  // `failed` and runs write_release_all — cleanup follows the role, so
  // no lock is needed and no chain can leak.
  if (fd >= 0) {
    epoll_ctl(disp->epfd, EPOLL_CTL_DEL, fd, nullptr);
    // shutdown (not close): in-flight reader/KeepWrite syscalls return
    // with EOF/EPIPE instead of racing a recycled fd number.
    ::shutdown(fd, SHUT_RDWR);
  }
  // wake any KeepWrite parked on EPOLLOUT
  epollout.value.fetch_add(1, std::memory_order_release);
  Scheduler::butex_wake(&epollout, INT32_MAX);
  if ((py_raw.load(std::memory_order_acquire) ||
       py_streams.load(std::memory_order_acquire)) &&
      server != nullptr) {
    // tell the Python protocol stack to drop this connection's session
    // natcheck:allow(resacct): PyRequest self-accounts in its ctor
    PyRequest* r = new PyRequest();
    r->kind = 2;
    r->sock_id = id;
    server->enqueue_py(r);
  }
  if (channel != nullptr) {
    // read-until-close HTTP bodies: EOF IS the response terminator —
    // complete the accumulated call before fail_all can error it
    if (httpc != nullptr) http_cli_on_socket_fail(this);
    if (channel->sock_id.load(std::memory_order_acquire) == id) {
      channel->fail_all(kEFAILEDSOCKET, "socket failed");
      if (channel->health_check_interval_ms > 0 &&
          !channel->closed.load(std::memory_order_acquire) &&
          !channel->hc_pending.exchange(true, std::memory_order_acq_rel)) {
        NAT_REF_ACQUIRE(channel, chan.revival);
        // fresh chain: the FIRST retry fires at the base interval; the
        // dial fiber grows the delay exponentially from there
        channel->hc_backoff_shift.store(0, std::memory_order_relaxed);
        TimerThread::instance()->schedule(health_check_fire, channel,
                                          channel->health_check_interval_ms);
      }
    } else {
      // already detached (GOAWAY drain): the channel's other pendings
      // ride the replacement socket and must survive — fail only the
      // streams this socket still owns. DEFERRED to a fiber: set_failed
      // can fire on a thread already inside h2c_mu (the reading thread's
      // window flush writing on a dying socket), and the sweep locks
      // h2c_mu — sweeping inline would self-deadlock (found by
      // tools/natcheck lockorder). With the scheduler stopped no such
      // thread exists (no fibers, no dispatchers feeding this socket),
      // so the inline sweep is both safe and the only way the pendings
      // still complete.
      if (Scheduler::instance()->started()) {
        NAT_REF_ACQUIRE(this, sock.sweep);
        // natcheck:allow(lock-switch): runs on a fresh fiber stack
        Scheduler::instance()->spawn_detached(
            [](void* raw) {
              NatSocket* s = (NatSocket*)raw;
              h2c_fail_own_streams(s, kEFAILEDSOCKET, "socket failed");
              // lame-duck-drained HTTP socket: its pipeline FIFO's
              // stragglers complete as planned errors, not hangs
              http_cli_fail_own(s, kEFAILEDSOCKET, "connection drained");
              NAT_REF_RELEASE(s, sock.sweep);
            },
            this);
      } else {
        h2c_fail_own_streams_teardown(this, kEFAILEDSOCKET,
                                      "socket failed");
        http_cli_fail_own(this, kEFAILEDSOCKET, "connection drained",
                          /*teardown=*/true);
      }
    }
  }
  if (server != nullptr) server->connections.fetch_sub(1, std::memory_order_relaxed);
  if (disp != nullptr) {
    disp->sockets_owned.fetch_sub(1, std::memory_order_relaxed);
  }
  sock_unregister(this);
  NAT_REF_RELEASE(this, sock.registry);
}

// Connection-close arming — the store-buffer (Dekker) pairing with the
// drain-role release: we STORE the flag then LOAD the stack head; the
// role holder STORES the head (grab_more's CAS to nullptr) then LOADS
// the flag — with a seq_cst fence between each side's store and load,
// at least one side must observe the other, so a Connection: close can
// never be missed by both (the atomicity the old write_mu provided).
void NatSocket::arm_close_after_drain() {
  close_after_drain.store(true, std::memory_order_seq_cst);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  if (write_idle() && !failed.load(std::memory_order_acquire)) {
    set_failed();
  }
}

void NatSocket::arm_epollout() {
  std::lock_guard g(epollctl_mu);
  if (failed.load(std::memory_order_acquire)) return;
  uint32_t want = EPOLLIN | EPOLLET | EPOLLOUT;
  if (epoll_events == want) return;
  struct epoll_event ev;
  ev.events = want;
  ev.data.u64 = id;
  if (epoll_ctl(disp->epfd, EPOLL_CTL_MOD, fd, &ev) == 0) epoll_events = want;
}

void NatSocket::disarm_epollout() {
  std::lock_guard g(epollctl_mu);
  if (failed.load(std::memory_order_acquire)) return;
  // a non-idle stack means a SUCCESSOR role holder exists (this fiber
  // already released the role) — it may just have armed EPOLLOUT for
  // its own park; disarming here would strand it without a wake (a
  // pre-existing race the role ledger makes checkable)
  if (!write_idle()) return;
  uint32_t want = EPOLLIN | EPOLLET;
  if (epoll_events == want) return;
  struct epoll_event ev;
  ev.events = want;
  ev.data.u64 = id;
  if (epoll_ctl(disp->epfd, EPOLL_CTL_MOD, fd, &ev) == 0) epoll_events = want;
}

// ---------------------------------------------------------------------------
// drain-role machinery (all functions below: role holder only)
// ---------------------------------------------------------------------------

// Fold every FIFO-linked node's bytes into wbuf, freeing the nodes as
// they empty — EXCEPT the chain terminator (wnext == nullptr), whose
// address doubles as the stack-head identity grab_more needs. Safe to
// call repeatedly: already-folded nodes are empty, new nodes linked by
// grab_more (or late-arriving pushers behind the terminator... which
// cannot happen — pushers go through the head) are appended in order.
void NatSocket::wgather() {
  WriteReq* r = wcur;
  while (true) {
    wbuf.append(std::move(r->data));
    WriteReq* next = r->wnext.load(std::memory_order_acquire);
    if (next == nullptr) {
      wcur = r;
      return;
    }
    wreq_free(r);
    r = next;
  }
}

// wbuf is empty: try to release the role. True = released (stack empty,
// terminator freed). False = fresh pushes arrived; they are gathered
// into wbuf and the drain continues.
bool NatSocket::wrefill() {
  WriteReq* last = wcur;
  // null BEFORE the role-releasing CAS: the next push-winner's plain
  // wcur store is ordered after the CAS (see write_push) — nulling
  // after would race it
  wcur = nullptr;
  WriteReq* more = wstack.grab_more(last);
  if (more == nullptr) {
    wreq_free(last);
    return true;
  }
  wcur = more;
  wreq_free(last);
  wgather();
  return false;
}

// Failed socket: free everything queued (including pushes racing in) and
// release the role. A writer that pushes AFTER this released checks
// `failed` post-push and cleans up after itself (write_raw).
void NatSocket::write_release_all() {
  // whatever is still queued will never reach the kernel
  c_unwritten.store(0, std::memory_order_relaxed);
  wbuf.clear();
  ring_sending = false;
  ring_inflight = 0;
  if (wcur == nullptr) return;
  while (true) {
    wgather();
    wbuf.clear();
    if (wrefill()) return;
  }
}

// Epoll-lane drain: gather + writev until empty (role released), EAGAIN
// (false: role retained, caller parks on EPOLLOUT) or failure (cleaned).
bool NatSocket::flush_chain() {
  while (true) {
    if (failed.load(std::memory_order_acquire)) {
      write_release_all();
      return true;
    }
    wgather();
    while (!wbuf.empty()) {
      // natfault write site: injected errno (EPIPE/ECONNRESET fail the
      // socket; EINTR/EAGAIN exercise the KeepWrite path), short writes
      // (1-byte truncation), dropped batches (bytes vanish — the
      // retry/backup machinery must recover). NF_DELAY is NOT honored
      // here: the inline first attempt runs under protocol session
      // locks on the py responder paths (express slow-writer scenarios
      // as read delays on the peer).
      NatFaultAct fwa = NAT_FAULT_POINT(NF_WRITE);
      ssize_t n;
      if (fwa.action == NF_ERR) {
        errno = fwa.err;
        n = -1;
      } else if (fwa.action == NF_DROP) {
        n = (ssize_t)wbuf.length();  // pretend the kernel took it all
        wbuf.clear();
      } else {
        n = wbuf.cut_into_fd(fd, fwa.action == NF_SHORT ? 1 : SIZE_MAX);
      }
      if (n > 0) {
        nat_counter_add(NS_SOCK_WRITE_BYTES, (uint64_t)n);
        c_out_bytes.fetch_add((uint64_t)n, std::memory_order_relaxed);
        c_write_calls.fetch_add(1, std::memory_order_relaxed);
        conn_unwritten_sub((uint64_t)n);
      }
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) {
          return false;  // role retained; caller parks on EPOLLOUT
        }
        set_failed();
        write_release_all();
        return true;
      }
    }
    if (wrefill()) {
      // role released: fence pairs with arm_close_after_drain (its
      // flag store + fence precede its head load — Dekker)
      std::atomic_thread_fence(std::memory_order_seq_cst);
      if (close_after_drain.load(std::memory_order_seq_cst) &&
          !failed.load(std::memory_order_acquire)) {
        // Connection: close — everything flushed; FIN follows the last
        // response byte (shutdown flushes kernel-buffered data)
        set_failed();
      }
      return true;
    }
  }
}

void keep_write_fiber(void* arg) {
  NatSocket* s = (NatSocket*)arg;
  while (true) {
    if (s->flush_chain()) break;  // drained or failed-and-cleaned
    int32_t expected = s->epollout.value.load(std::memory_order_acquire);
    s->arm_epollout();
    // second attempt covers a became-writable-before-arm race
    if (s->flush_chain()) break;
    Scheduler::butex_wait(&s->epollout, expected);
  }
  s->disarm_epollout();
  NAT_REF_RELEASE(s, sock.keepwrite);
}

// Ring-lane submission step — entered by a fresh drainer, a send
// completion, or the retry pass; the role holder either parks (send in
// flight / retry list) or finishes (released / failed / demoted-to-
// epoll continuation).
void NatSocket::wring_continue() {
  while (true) {
    if (failed.load(std::memory_order_acquire)) {
      write_release_all();
      return;
    }
    if (ring_sending) return;  // the completion continues the role
    wgather();
    int64_t rr = ring_ref.load(std::memory_order_acquire);
    if (rr < 0 || ring == nullptr) {
      // demoted mid-drain: the bytes continue on the epoll lane
      if (!flush_chain()) {
        NAT_REF_ACQUIRE(this, sock.keepwrite);
        Scheduler::instance()->spawn_detached(keep_write_fiber, this);
      }
      return;
    }
    if (wbuf.empty()) {
      if (wrefill()) {
        // role released: Dekker fence vs arm_close_after_drain
        std::atomic_thread_fence(std::memory_order_seq_cst);
        if (close_after_drain.load(std::memory_order_seq_cst) &&
            !failed.load(std::memory_order_acquire)) {
          set_failed();
        }
        return;
      }
      continue;
    }
    uint16_t buf;
    char* dst = ring->acquire_send_buffer(&buf);
    if (dst == nullptr) {
      ring_retry_park(this);
      return;
    }
    size_t n = wbuf.length();
    if (n > RingListener::kSendBufSize) n = RingListener::kSendBufSize;
    wbuf.copy_to(dst, n);  // straight into registered memory
    // in-flight state published BEFORE the submit: the completion (the
    // role's next holder) may run the instant the SQE is visible, and
    // nothing here may be touched after a successful submit. The send
    // owns a reference AND the drain role; its tag is the socket
    // POINTER (slabs are never freed, and the ref pins the slot against
    // recycling), so the completion needs no id lookup.
    ring_sending = true;
    ring_inflight = n;
    NAT_REF_ACQUIRE(this, sock.ringsend);
    if (!ring->submit_send((int)(rr & 0xffffffff), (uint32_t)(rr >> 32),
                           (uint64_t)(uintptr_t)this, buf, n)) {
      ring_sending = false;  // no completion will come: undo + park
      ring_inflight = 0;
      NAT_REF_RELEASE(this, sock.ringsend);
      ring_retry_park(this);
      return;
    }
    return;
  }
}

// A push just made the caller the drainer: drive the drain one step on
// the right lane.
void NatSocket::wdrive() {
  if (ring_ref.load(std::memory_order_acquire) >= 0 && ring != nullptr) {
    wring_continue();
    return;
  }
  // Inline first attempt on the caller's thread/fiber (socket.cpp:1287);
  // leftovers go to a KeepWrite fiber waiting on EPOLLOUT.
  if (!flush_chain()) {
    NAT_REF_ACQUIRE(this, sock.keepwrite);
    Scheduler::instance()->spawn_detached(keep_write_fiber, this);
  }
}

// ---------------------------------------------------------------------------
// write entries
// ---------------------------------------------------------------------------

int NatSocket::write(IOBuf&& frame) {
  if (ssl_sess != nullptr) {
    int rc = ssl_encrypt_and_write(this, std::move(frame));
    if (rc < 0) set_failed();
    return rc;
  }
  return write_raw(std::move(frame));
}

// Enqueue only (wait-free). True = caller became the drainer (wcur is
// set to the pushed node) and must drive the drain — after releasing any
// session locks it holds: order on the wire is fixed at PUSH time, so
// the drain itself needs no lock.
bool NatSocket::write_push(IOBuf&& frame) {
  WriteReq* r = wreq_alloc();
  c_unwritten.fetch_add(frame.length(), std::memory_order_relaxed);
  r->data = std::move(frame);
  if (wstack.push(r)) {
    // safe plain store: the push exchange that made us the drainer
    // happens-after the previous drainer's role-releasing CAS, which
    // happens-after it nulled wcur (wrefill nulls BEFORE the CAS)
    wcur = r;
    return true;
  }
  return false;
}

int NatSocket::write_raw(IOBuf&& frame) {
  if (failed.load(std::memory_order_acquire)) return -1;
  if (!write_push(std::move(frame))) {
    return 0;  // active drainer will take it
  }
  // became the drainer; a failure that raced the pre-push check is OUR
  // cleanup now (the failed side's release_all has already run or never
  // held the role)
  if (failed.load(std::memory_order_acquire)) {
    write_release_all();
    return -1;
  }
  if (defer_writes) {
    // Batch mode: the writer fiber runs AFTER the currently-ready fibers,
    // so their appends coalesce into one writev.
    NAT_REF_ACQUIRE(this, sock.keepwrite);
    Scheduler::instance()->spawn_detached_back(keep_write_fiber, this);
    return 0;
  }
  wdrive();
  return 0;
}

// ---------------------------------------------------------------------------
// ring lane (completion drain, demotion, adoption)
// ---------------------------------------------------------------------------

// Moves a ring socket to the epoll lane (rearm impossible / multishot
// unsupported); the CAS makes demotion and set_failed mutually exclusive.
// Queued bytes need no hand-off: the drain role is continuous, and every
// role holder re-checks ring_ref before submitting (a parked role on the
// retry list or an in-flight completion continues on the epoll lane).
static void ring_demote_to_epoll(NatSocket* s, int64_t rr) {
  if (s->ring_ref.compare_exchange_strong(rr, -1,
                                          std::memory_order_seq_cst)) {
    s->ring->unregister_file((int)(rr & 0xffffffff));
    s->disp->add_consumer(s);
  }
}

// Drains one ring's harvested completions — the wait_task drain of the
// fork (task_group.cpp:158-169): recv bytes feed the SAME cut loop the
// epoll readers use; send completions recycle fixed buffers and continue
// the owning socket's drain role. One drainer per ring at a time (the
// per-ring baton) keeps per-socket completion order.
bool ring_drain_one(RingListener* ring) {
  if (ring == nullptr) return false;
  if (ring->draining.exchange(true, std::memory_order_acquire)) {
    return false;
  }
  bool did = false;
  RingCompletion c;
  while (ring->pop_completion(&c)) {
    did = true;
    if (c.kind == 0) {  // recv
      NatSocket* s = sock_address(c.tag);
      if (c.res > 0) {
        if (s != nullptr && !s->failed.load(std::memory_order_acquire)) {
          nat_counter_add(NS_SOCK_READ_BYTES, (uint64_t)c.res);
          s->c_in_bytes.fetch_add((uint64_t)c.res,
                                  std::memory_order_relaxed);
          s->c_read_calls.fetch_add(1, std::memory_order_relaxed);
          if (s->ssl_sess != nullptr) {
            // TLS: ciphertext feeds the session; plaintext lands in
            // in_buf inside ssl_feed
            if (!ssl_feed(s, ring->buffer_data(c.buf_id),
                          (size_t)c.res)) {
              ring->recycle_buffer(c.buf_id);
              s->set_failed();
              NAT_REF_RELEASE(s, sock.borrow);
              continue;
            }
          } else {
            const char* src = ring->buffer_data(c.buf_id);
            size_t len = (size_t)c.res;
            if (s->fill_req != nullptr) {
              // stream fill mode: payload bytes skip in_buf entirely
              size_t took = stream_fill_feed(s, src, len);
              if (took == SIZE_MAX) {  // allocation failed
                ring->recycle_buffer(c.buf_id);
                s->set_failed();
                NAT_REF_RELEASE(s, sock.borrow);
                continue;
              }
              src += took;
              len -= took;
            }
            if (s->bulk_buf != nullptr && len > 0) {
              // bulk-frame fill: body bytes land in the pooled slab;
              // the remainder (next frame) takes the normal path
              size_t took = bulk_fill_feed(s, src, len);
              src += took;
              len -= took;
            }
            if (len > 0) s->in_buf.append(src, len);
          }
          ring->recycle_buffer(c.buf_id);
          int64_t rr = s->ring_ref.load(std::memory_order_acquire);
          bool in_ok = process_input(s);
          s->c_rdbuf.store(s->in_buf.length(), std::memory_order_relaxed);
          if (!in_ok) {
            s->set_failed();
          } else if (!c.more && rr >= 0 &&
                     !ring->rearm_recv((int)(rr & 0xffffffff),
                                       (uint32_t)(rr >> 32), s->id)) {
            ring_demote_to_epoll(s, rr);  // SQ full: don't go deaf
          }
        } else {
          ring->recycle_buffer(c.buf_id);  // owner gone: recycle only
        }
      } else if (s != nullptr) {
        int64_t rr = s->ring_ref.load(std::memory_order_acquire);
        if (c.res == -ENOBUFS) {
          // provided buffers were exhausted; they're recycled as we
          // drain, so re-arm and keep going
          if (rr >= 0 && !ring->rearm_recv((int)(rr & 0xffffffff),
                                           (uint32_t)(rr >> 32), s->id)) {
            ring_demote_to_epoll(s, rr);
          }
        } else if (c.res == -EINVAL && rr >= 0) {
          // kernel lacks multishot recv (pre-6.0): demote this
          // connection to the epoll lane instead of killing it
          ring_demote_to_epoll(s, rr);
        } else if (!c.more) {
          s->set_failed();  // EOF (0) or hard error
        }
      }
      if (s != nullptr) NAT_REF_RELEASE(s, sock.borrow);
    } else {  // send: the completion IS the drain-role continuation
      ring->recycle_send_buffer(c.send_buf);
      NatSocket* s = (NatSocket*)(uintptr_t)c.tag;
      // non-owning pointer use justified by the sock.ringsend reference
      // the submit took (slabs never free; the ref pins the slot)
      NAT_REF_BORROW(s);
      if (s != nullptr) {
        s->ring_sending = false;
        if (c.res < 0) {
          s->set_failed();
          s->write_release_all();
        } else {
          size_t done = (size_t)c.res;
          if (done > s->ring_inflight) done = s->ring_inflight;
          nat_counter_add(NS_SOCK_WRITE_BYTES, done);
          s->c_out_bytes.fetch_add(done, std::memory_order_relaxed);
          s->c_write_calls.fetch_add(1, std::memory_order_relaxed);
          s->conn_unwritten_sub(done);
          s->wbuf.pop_front(done);
          s->ring_inflight = 0;
          s->wring_continue();  // next chunk / refill / release / close
        }
        NAT_REF_RELEASE(s, sock.ringsend);
      }
    }
  }
  // resume drains parked for a free SQE/send buffer (every entry owns
  // its socket's drain role and a reference)
  std::vector<NatSocket*> retry;
  {
    std::lock_guard g(g_ring_retry_mu);
    retry.swap(g_ring_retry);
  }
  for (NatSocket* s : retry) {
    s->wring_continue();
    NAT_REF_RELEASE(s, sock.ringretry);
  }
  ring->draining.store(false, std::memory_order_release);
  return did;
}

// Idle-hook drain: every per-dispatcher ring in turn.
bool ring_drain() {
  if (!g_rings_ready.load(std::memory_order_acquire)) return false;
  bool did = false;
  for (RingListener* r : g_rings) did |= ring_drain_one(r);
  return did;
}

// Put a freshly-connected fd on its dispatcher's ring when the lane is
// enabled (both directions then ride io_uring and drain on the poller —
// the accept path's twin). Returns true when the ring owns the reads.
bool try_ring_adopt(NatSocket* s) {
  if (!g_use_ring.load(std::memory_order_acquire)) return false;
  RingListener* ring = s->disp != nullptr ? s->disp->ring : nullptr;
  if (ring == nullptr) return false;
  uint32_t gen = 0;
  int fidx = ring->register_file(s->fd, &gen);
  if (fidx < 0) return false;
  s->ring = ring;  // published before ring_ref: completions read it
  int64_t rr = ((int64_t)gen << 32) | (uint32_t)fidx;
  s->ring_ref.store(rr, std::memory_order_release);
  if (ring->rearm_recv(fidx, gen, s->id)) return true;
  s->ring_ref.store(-1, std::memory_order_release);
  ring->unregister_file(fidx);
  return false;
}

// ---------------------------------------------------------------------------
// native /connections snapshot (connections_service.cpp role): walk the
// registry's high-water mark and fill one row per live socket. Lock-free
// — liveness is judged by the versioned_ref refcount, counters are
// relaxed atomics, and the protocol column is derived from the session
// pointers the single reading thread owns (a mid-recycle row can at
// worst show a freshly-reset socket's zeros; this is a debug page).
// ---------------------------------------------------------------------------

// no_sanitize: the SERVER-side protocol session pointers (http/h2/redis)
// and ssl_sess are sniff-assigned by the owning dispatcher thread after
// the conn_visible gate; this walker only null-tests them (never
// dereferences) to derive the protocol column, and a stale null at
// worst labels a just-sniffed socket "?" for one scrape. Everything
// else read here is either an atomic or ordered by conn_visible.
__attribute__((no_sanitize("thread")))
static void conn_fill_row(NatSocket* s, NatConnRow* r) {
  r->sock_id = s->id.load(std::memory_order_relaxed);
  r->in_bytes = s->c_in_bytes.load(std::memory_order_relaxed);
  r->out_bytes = s->c_out_bytes.load(std::memory_order_relaxed);
  r->in_msgs = s->c_in_msgs.load(std::memory_order_relaxed);
  r->out_msgs = s->c_out_msgs.load(std::memory_order_relaxed);
  r->read_calls = s->c_read_calls.load(std::memory_order_relaxed);
  r->write_calls = s->c_write_calls.load(std::memory_order_relaxed);
  r->unwritten_bytes = s->c_unwritten.load(std::memory_order_relaxed);
  r->mem_bytes = r->unwritten_bytes +
                 s->c_rdbuf.load(std::memory_order_relaxed) +
                 s->c_parked.load(std::memory_order_relaxed);
  r->fd = s->fd;
  r->disp_idx = s->disp != nullptr ? s->disp->idx : -1;
  r->server_side = s->server != nullptr ? 1 : 0;
  const char* proto = "?";
  if (s->http != nullptr) proto = "http";
  else if (s->h2 != nullptr) proto = "h2";
  else if (s->redis != nullptr) proto = "redis";
  else if (s->httpc != nullptr) proto = "http_cli";
  else if (s->h2c != nullptr) proto = "h2_cli";
  else if (s->spoke_tpu_std.load(std::memory_order_relaxed)) proto = "tpu_std";
  else if (s->py_streams.load(std::memory_order_relaxed)) proto = "stream";
  else if (s->py_raw.load(std::memory_order_relaxed)) proto = "raw";
  else if (s->channel != nullptr) proto = "tpu_std";
  if (s->ssl_sess != nullptr) proto = "tls";
  snprintf(r->protocol, sizeof(r->protocol), "%s", proto);
  memcpy(r->remote, s->peer, sizeof(r->remote) < sizeof(s->peer)
                                 ? sizeof(r->remote)
                                 : sizeof(s->peer));
  r->remote[sizeof(r->remote) - 1] = '\0';
}

}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

// Fill up to `max` rows with the live native sockets; returns rows
// written. A row is "live" when its registry slot holds a reference and
// an open fd (closed/recycled slots are skipped). Each row is filled
// under a borrowed reference (the sock_address discipline): the CAS from
// a nonzero refcount pins the socket so release()'s teardown — which
// frees sessions and closes the fd the row reads — cannot run mid-fill.
int nat_conn_snapshot(brpc_tpu::NatConnRow* out, int max) {
  int n = 0;
  uint32_t hwm;
  {
    std::lock_guard g(g_sock_alloc_mu);
    hwm = g_sock_next_idx;
  }
  for (uint32_t idx = 0; idx < hwm && n < max; idx++) {
    NatSocket* s = sock_at(idx);
    if (s == nullptr) continue;
    if (sock_try_pin(s) == nullptr) continue;
    // conn_visible (acquire) orders every setup write — fd, peer, disp,
    // channel/server, client session attach — before this row's reads:
    // the pin alone is not enough, sock_create publishes versioned_ref
    // before the creating thread has filled those plain fields
    if (s->conn_visible.load(std::memory_order_acquire) &&
        !s->failed.load(std::memory_order_acquire) && s->fd >= 0) {
      conn_fill_row(s, &out[n]);
      if (out[n].sock_id != 0) n++;
    }
    NAT_REF_RELEASE(s, sock.borrow);
  }
  return n;
}

}  // extern "C"
