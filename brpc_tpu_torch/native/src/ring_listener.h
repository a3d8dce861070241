// RingListener — the io_uring datapath of the monographdb fork, rebuilt on
// raw syscalls (no liburing in this image).
//
// Counterpart of bthread/ring_listener.h (/root/reference/src/bthread/
// ring_listener.h:65-143) + inbound_ring_buf.h: one io_uring instance with
//   * registered sparse FILES (sockets address the kernel by fixed index),
//   * a PROVIDED BUFFER RING for receives — the kernel picks a
//     pre-registered buffer per completion, so the hot read path does no
//     allocation and no extra syscall,
//   * multishot RECV per socket (one SQE, many completions),
//   * fixed-buffer SENDs from registered memory (ring_write_buf_pool.h),
//   * a poller thread harvesting CQEs into a completion queue that the
//     FIBER SCHEDULER drains from its idle loop (task_group.cpp:158-169
//     drains the SPSC into wait_task) — completions are processed by
//     workers, not by the poller.
//
// The class is transport-generic: the RPC runtime (nat_rpc.cpp) owns
// sockets and framing; completions come back tagged with the caller's id.
#pragma once

#include <linux/io_uring.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <deque>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>
#include "nat_lockrank.h"

// Provided-buffer-ring ABI under this library's own names, with the
// kernel's layout (struct io_uring_buf / io_uring_buf_reg and opcode 22 of
// io_uring_register). Headers differ in which of the kernel's names they
// define, and how (a macro in some, an enum member in others), so the
// header's versions are never used and none can clash with these. init()
// probes kernel support at runtime: on a kernel without the ABI the setup
// syscall fails and the runtime stays on epoll.
static constexpr unsigned kNatRegisterPbufRing = 22;
struct nat_pbuf_entry {
  __u64 addr;
  __u32 len;
  __u16 bid;
  __u16 resv;
};
struct nat_pbuf_reg {
  __u64 ring_addr;
  __u32 ring_entries;
  __u16 bgid;
  __u16 flags;
  __u64 resv[3];
};
static_assert(sizeof(nat_pbuf_entry) == 16, "kernel io_uring_buf layout");
static_assert(sizeof(nat_pbuf_reg) == 40, "kernel io_uring_buf_reg layout");
#ifndef IORING_RECV_MULTISHOT
#define IORING_RECV_MULTISHOT (1U << 1)
#endif
// SQPOLL ABI (5.1+; values are kernel wire ABI, probed at runtime)
#ifndef IORING_SETUP_SQPOLL
#define IORING_SETUP_SQPOLL (1U << 1)
#endif
#ifndef IORING_SQ_NEED_WAKEUP
#define IORING_SQ_NEED_WAKEUP (1U << 0)
#endif
#ifndef IORING_ENTER_SQ_WAKEUP
#define IORING_ENTER_SQ_WAKEUP (1U << 1)
#endif

namespace brpc_tpu {

// One harvested completion, handed from the poller to a worker
// (InboundRingBuf's role, inbound_ring_buf.h:28-54).
struct RingCompletion {
  uint64_t tag = 0;     // caller-chosen id (socket id)
  int kind = 0;         // 0 = recv, 1 = send
  int32_t res = 0;      // CQE result (bytes or -errno)
  uint16_t buf_id = 0;  // provided buffer carrying the bytes (recv)
  uint16_t send_buf = 0;  // fixed buffer to recycle (send)
  bool more = false;    // multishot still armed (IORING_CQE_F_MORE)
};

class RingListener {
 public:
  static constexpr unsigned kEntries = 256;     // SQ depth
  // provided recv buffers: 64KB each (was 16KB) — a bulk sender fills
  // whole buffers, so per-completion payload quadruples and the
  // completion-handling overhead per MB drops 4x (stream lane lever)
  static constexpr unsigned kNumBufs = 256;
  static constexpr unsigned kBufSize = 65536;
  // 256KB fixed send buffers (was 64KB): one-in-flight-per-socket keeps
  // TCP ordering under short writes (independent io_uring sends may
  // execute out of order, and IOSQE_IO_LINK continues after a short
  // write), so per-completion payload is the bandwidth lever for large
  // responses (ring_write_buf_pool.h role). 64 x 256KB = 16MB pinned.
  static constexpr unsigned kNumSendBufs = 64;
  static constexpr unsigned kSendBufSize = 262144;
  static constexpr unsigned kMaxFiles = 4096;   // registered-file table

  ~RingListener() { shutdown(); }

  bool available() const { return ring_fd_ >= 0; }

  // Sets up the ring, provided-buffer ring, file table, send buffers and
  // the poller thread. False when the kernel/sandbox refuses io_uring.
  // SQPOLL is probed first (unless NAT_SQPOLL=0): with a kernel SQ
  // poller thread the steady-state submit path is a tail store + a
  // need-wakeup check — ~zero syscalls — and registered files/buffers
  // (which SQPOLL requires anyway) are already the only ops submitted.
  // Unprivileged SQPOLL needs a 5.11+ kernel; older/denied setups fall
  // back to plain io_uring, then to epoll.
  bool init(unsigned entries = kEntries);
  void shutdown();

  // True when this ring runs with a kernel SQ poller (IORING_SETUP_SQPOLL
  // accepted at init) — surfaced per dispatcher in /vars.
  bool sqpoll_active() const { return sqpoll_; }

  // Per-ring drain baton: one completion drainer at a time preserves
  // per-socket completion order (held by ring_drain_one).
  std::atomic<bool> draining{false};

  // Registers fd into the fixed-file table WITHOUT arming recv; the
  // caller publishes the returned index (and generation) on its socket
  // first, then arms via rearm_recv — completions may fire the instant
  // recv is armed, so the index must be visible before then. Returns -1
  // when the table is exhausted. Slots ARE recycled: unregister_file
  // bumps the slot's generation, and every rearm/send validates the
  // caller's generation under the registration lock, so a stale in-flight
  // rearm can never target a reused slot (connection churn no longer
  // spends the table).
  int register_file(int fd, uint32_t* gen_out);
  void unregister_file(int file_index);

  // Re-arms multishot recv after the kernel dropped it (more==false).
  // False when no SQE is free OR the slot generation moved (caller
  // should demote to the epoll lane either way).
  bool rearm_recv(int file_index, uint32_t gen, uint64_t tag);

  // Fixed-buffer send, zero intermediate copies: acquire a registered
  // buffer, fill it directly, then submit. acquire_send_buffer returns
  // the writable pointer or nullptr when the pool is empty;
  // submit_send consumes the buffer (returns false when no SQE is free —
  // the buffer is released back to the pool). `tag` and the buffer index
  // come back in the send completion.
  char* acquire_send_buffer(uint16_t* buf_out);
  void release_send_buffer(uint16_t buf);
  bool submit_send(int file_index, uint32_t gen, uint64_t tag, uint16_t buf,
                   size_t len);

  // Bytes of a recv completion; valid until recycle_buffer(buf_id).
  const char* buffer_data(uint16_t buf_id) const {
    return buf_base_ + (size_t)buf_id * kBufSize;
  }
  void recycle_buffer(uint16_t buf_id);
  void recycle_send_buffer(uint16_t idx);

  struct nat_pbuf_entry* ring_entry(unsigned idx) {
    return (struct nat_pbuf_entry*)buf_ring_ + idx;
  }
  std::atomic<uint16_t>* ring_tail_atomic() {
    // tail lives in entry 0's resv halfword (ring base + 14)
    return (std::atomic<uint16_t>*)((char*)buf_ring_ + 14);
  }

  // Called by the poller after enqueuing completions — wires to the
  // scheduler's wake (task_group ExtWakeup role) so completions don't
  // wait out a park timeout.
  void set_wake_fn(std::function<void()> fn) { wake_fn_ = std::move(fn); }

  // When set, the POLLER ITSELF runs this after harvesting completions
  // (the inline-drain discipline the epoll dispatcher uses: every
  // consumer of a completion is non-blocking, so handing the batch to a
  // parked worker only added wake latency). Must return false when the
  // drain was SKIPPED (another drainer holds the baton) — the poller
  // then falls back to waking a worker so the harvest can't stall out a
  // full park timeout. Worker idle hooks still drain as a backup.
  void set_drain_fn(std::function<bool()> fn) { drain_fn_ = std::move(fn); }

  // Pops one harvested completion; the scheduler idle hook loops this
  // (the wait_task drain, task_group.cpp:158-169).
  bool pop_completion(RingCompletion* out) {
    std::lock_guard g(comp_mu_);
    if (comp_q_.empty()) return false;
    *out = comp_q_.front();
    comp_q_.pop_front();
    return true;
  }

  uint64_t recv_completions() const {
    return n_recv_.load(std::memory_order_relaxed);
  }
  uint64_t send_completions() const {
    return n_send_.load(std::memory_order_relaxed);
  }

 private:
  bool setup_rings(unsigned entries);
  bool setup_buf_ring();
  bool setup_files_and_sendbufs();
  struct io_uring_sqe* get_sqe_locked();
  void submit_locked();
  void flush_unsubmitted_locked();
  void poller_loop();

  int ring_fd_ = -1;
  bool sqpoll_ = false;
  // SQ mmap
  void* sq_ring_ = nullptr;
  size_t sq_ring_sz_ = 0;
  std::atomic<unsigned>* sq_head_ = nullptr;
  std::atomic<unsigned>* sq_tail_ = nullptr;
  std::atomic<unsigned>* sq_flags_ = nullptr;  // NEED_WAKEUP under SQPOLL
  unsigned* sq_mask_ = nullptr;
  unsigned* sq_array_ = nullptr;
  struct io_uring_sqe* sqes_ = nullptr;
  size_t sqes_sz_ = 0;
  // CQ mmap
  void* cq_ring_ = nullptr;
  size_t cq_ring_sz_ = 0;
  std::atomic<unsigned>* cq_head_ = nullptr;
  std::atomic<unsigned>* cq_tail_ = nullptr;
  unsigned* cq_mask_ = nullptr;
  struct io_uring_cqe* cqes_ = nullptr;

  // provided buffer ring (IORING_REGISTER_PBUF_RING, bgid 0).
  // NOTE kernel ABI: ring entries start at the ring BASE (entry 0's tail
  // halfword doubles as the ring tail) — the C++ expansion of
  // io_uring_buf_ring's flex-array union puts `bufs` at offset 8, so we
  // address entries manually instead of through that member.
  void* buf_ring_ = nullptr;
  size_t buf_ring_sz_ = 0;
  char* buf_base_ = nullptr;  // kNumBufs * kBufSize payload arena
  unsigned buf_mask_ = 0;
  uint16_t buf_ring_tail_ = 0;
  NatMutex<kLockRankRingBuf> buf_mu_;

  // fixed send buffers (IORING_REGISTER_BUFFERS)
  char* send_base_ = nullptr;
  std::vector<uint16_t> send_free_;
  std::vector<uint64_t> send_tag_;  // buf index -> in-flight tag
  NatMutex<kLockRankRingSend> send_mu_;

  NatMutex<kLockRankRingSq> sq_mu_;
  NatMutex<kLockRankRingComp> comp_mu_;
  std::deque<RingCompletion> comp_q_;
  std::thread poller_;
  std::atomic<bool> stop_{false};
  std::atomic<uint64_t> n_recv_{0};
  std::atomic<uint64_t> n_send_{0};
  NatMutex<kLockRankRingFiles> files_mu_;
  unsigned next_file_ = 0;         // high-water mark
  std::vector<int> free_files_;    // recycled slots
  std::vector<uint32_t> file_gen_;  // slot generation (bumped on unregister)
  std::function<void()> wake_fn_;
  std::function<bool()> drain_fn_;
  unsigned unsubmitted_ = 0;  // SQEs published but not yet accepted
};

}  // namespace brpc_tpu
