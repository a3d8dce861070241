// RingListener implementation — see ring_listener.h for the design map
// onto /root/reference/src/bthread/ring_listener.h.
#include "ring_listener.h"

#include <errno.h>
#include <stdlib.h>
#include <sys/uio.h>

#include "nat_fault.h"

namespace brpc_tpu {

namespace {
constexpr uint64_t kKindRecv = 0;
constexpr uint64_t kKindSend = 1;
constexpr uint64_t kKindNop = 3;

// user_data layout: kind in the top 2 bits. Recv user_data carries the
// caller's 62-bit tag (socket ids are 32 idx + 32 version bits; versions
// never approach 2^30, so bit 62/63 are free). Send completions identify
// their socket through the fixed-buffer tag table (send_tag_) and only
// carry the buffer index.
constexpr uint64_t kTagMask = (1ull << 62) - 1;
inline uint64_t make_recv_ud(uint64_t tag) {
  return (kKindRecv << 62) | (tag & kTagMask);
}
inline uint64_t make_send_ud(uint64_t buf) {
  return (kKindSend << 62) | (buf & 0xFFFF);
}
inline uint64_t make_nop_ud() { return kKindNop << 62; }
inline uint64_t ud_tag(uint64_t ud) { return ud & kTagMask; }
inline uint64_t ud_kind(uint64_t ud) { return ud >> 62; }
inline uint16_t ud_aux(uint64_t ud) { return (uint16_t)(ud & 0xFFFF); }

inline int sys_setup(unsigned entries, struct io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
inline int sys_enter(int fd, unsigned to_submit, unsigned min_complete,
                     unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, nullptr, 0);
}
inline int sys_register(int fd, unsigned opcode, void* arg,
                        unsigned nr_args) {
  return (int)syscall(__NR_io_uring_register, fd, opcode, arg, nr_args);
}
}  // namespace

bool RingListener::setup_rings(unsigned entries) {
  struct io_uring_params p;
  // SQPOLL probe: a kernel SQ poller makes steady-state submission a
  // tail store (no io_uring_enter unless the poller idled out and set
  // NEED_WAKEUP). Unprivileged SQPOLL needs 5.11+; refused setups fall
  // back to a plain ring. NAT_SQPOLL=0 force-disables the probe.
  const char* sq_env = getenv("NAT_SQPOLL");
  if (sq_env == nullptr || sq_env[0] != '0') {
    memset(&p, 0, sizeof(p));
    p.flags = IORING_SETUP_SQPOLL;
    p.sq_thread_idle = 50;  // ms before the kernel poller sleeps
    ring_fd_ = sys_setup(entries, &p);
    if (ring_fd_ >= 0) sqpoll_ = true;
  }
  if (ring_fd_ < 0) {
    memset(&p, 0, sizeof(p));
    ring_fd_ = sys_setup(entries, &p);
    sqpoll_ = false;
  }
  if (ring_fd_ < 0) return false;

  sq_ring_sz_ = p.sq_off.array + p.sq_entries * sizeof(unsigned);
  cq_ring_sz_ = p.cq_off.cqes + p.cq_entries * sizeof(struct io_uring_cqe);
  sq_ring_ = mmap(nullptr, sq_ring_sz_, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd_, IORING_OFF_SQ_RING);
  if (sq_ring_ == MAP_FAILED) return false;
  cq_ring_ = mmap(nullptr, cq_ring_sz_, PROT_READ | PROT_WRITE,
                  MAP_SHARED | MAP_POPULATE, ring_fd_, IORING_OFF_CQ_RING);
  if (cq_ring_ == MAP_FAILED) return false;
  sqes_sz_ = p.sq_entries * sizeof(struct io_uring_sqe);
  sqes_ = (struct io_uring_sqe*)mmap(nullptr, sqes_sz_,
                                     PROT_READ | PROT_WRITE,
                                     MAP_SHARED | MAP_POPULATE, ring_fd_,
                                     IORING_OFF_SQES);
  if (sqes_ == MAP_FAILED) return false;

  char* sq = (char*)sq_ring_;
  sq_head_ = (std::atomic<unsigned>*)(sq + p.sq_off.head);
  sq_tail_ = (std::atomic<unsigned>*)(sq + p.sq_off.tail);
  sq_flags_ = (std::atomic<unsigned>*)(sq + p.sq_off.flags);
  sq_mask_ = (unsigned*)(sq + p.sq_off.ring_mask);
  sq_array_ = (unsigned*)(sq + p.sq_off.array);
  char* cq = (char*)cq_ring_;
  cq_head_ = (std::atomic<unsigned>*)(cq + p.cq_off.head);
  cq_tail_ = (std::atomic<unsigned>*)(cq + p.cq_off.tail);
  cq_mask_ = (unsigned*)(cq + p.cq_off.ring_mask);
  cqes_ = (struct io_uring_cqe*)(cq + p.cq_off.cqes);
  return true;
}

bool RingListener::setup_buf_ring() {
  // the provided-buffer ring itself (entries must be a power of two)
  buf_ring_sz_ = kNumBufs * sizeof(struct nat_pbuf_entry);
  void* ring_mem = mmap(nullptr, buf_ring_sz_, PROT_READ | PROT_WRITE,
                        MAP_ANONYMOUS | MAP_PRIVATE | MAP_POPULATE, -1, 0);
  if (ring_mem == MAP_FAILED) return false;
  // Pre-fault before the kernel pins the pages: pinning a never-touched
  // anonymous mapping leaves it unwritable on some kernels.
  memset(ring_mem, 0, buf_ring_sz_);
  buf_ring_ = ring_mem;
  buf_mask_ = kNumBufs - 1;

  struct nat_pbuf_reg reg;
  memset(&reg, 0, sizeof(reg));
  reg.ring_addr = (uint64_t)(uintptr_t)buf_ring_;
  reg.ring_entries = kNumBufs;
  reg.bgid = 0;
  if (sys_register(ring_fd_, kNatRegisterPbufRing, &reg, 1) < 0) {
    return false;
  }

  // payload arena: one block carved into kNumBufs buffers
  buf_base_ = (char*)mmap(nullptr, (size_t)kNumBufs * kBufSize,
                          PROT_READ | PROT_WRITE,
                          MAP_ANONYMOUS | MAP_PRIVATE | MAP_POPULATE, -1, 0);
  if (buf_base_ == (char*)MAP_FAILED) {
    buf_base_ = nullptr;
    return false;
  }
  memset(buf_base_, 0, (size_t)kNumBufs * kBufSize);  // pre-fault
  // publish every buffer to the kernel
  for (unsigned i = 0; i < kNumBufs; i++) {
    struct nat_pbuf_entry* b = ring_entry(buf_ring_tail_ & buf_mask_);
    b->addr = (uint64_t)(uintptr_t)(buf_base_ + (size_t)i * kBufSize);
    b->len = kBufSize;
    b->bid = (uint16_t)i;
    buf_ring_tail_++;
  }
  ring_tail_atomic()->store(buf_ring_tail_, std::memory_order_release);
  return true;
}

bool RingListener::setup_files_and_sendbufs() {
  // sparse registered-file table (ring_listener.h:88 registers 1024)
  std::vector<int> fds(kMaxFiles, -1);
  if (sys_register(ring_fd_, IORING_REGISTER_FILES, fds.data(),
                   kMaxFiles) < 0) {
    return false;
  }
  // fixed send buffers (ring_write_buf_pool.h)
  send_base_ = (char*)mmap(nullptr, (size_t)kNumSendBufs * kSendBufSize,
                           PROT_READ | PROT_WRITE,
                           MAP_ANONYMOUS | MAP_PRIVATE | MAP_POPULATE, -1, 0);
  if (send_base_ == (char*)MAP_FAILED) {
    send_base_ = nullptr;
    return false;
  }
  memset(send_base_, 0, (size_t)kNumSendBufs * kSendBufSize);  // pre-fault
  std::vector<struct iovec> iovs(kNumSendBufs);
  for (unsigned i = 0; i < kNumSendBufs; i++) {
    iovs[i].iov_base = send_base_ + (size_t)i * kSendBufSize;
    iovs[i].iov_len = kSendBufSize;
  }
  if (sys_register(ring_fd_, IORING_REGISTER_BUFFERS, iovs.data(),
                   kNumSendBufs) < 0) {
    return false;
  }
  send_free_.reserve(kNumSendBufs);
  for (int i = (int)kNumSendBufs - 1; i >= 0; i--)
    send_free_.push_back((uint16_t)i);
  send_tag_.assign(kNumSendBufs, 0);
  return true;
}

bool RingListener::init(unsigned entries) {
  if (!setup_rings(entries) || !setup_buf_ring()
      || !setup_files_and_sendbufs()) {
    shutdown();
    return false;
  }
  stop_.store(false, std::memory_order_relaxed);
  poller_ = std::thread([this] { poller_loop(); });
  return true;
}

void RingListener::shutdown() {
  if (ring_fd_ < 0) return;
  stop_.store(true, std::memory_order_relaxed);
  // a NOP submission breaks the poller out of GETEVENTS
  {
    std::lock_guard g(sq_mu_);
    struct io_uring_sqe* sqe = get_sqe_locked();
    if (sqe != nullptr) {
      memset(sqe, 0, sizeof(*sqe));
      sqe->opcode = IORING_OP_NOP;
      sqe->user_data = make_nop_ud();
      submit_locked();
    }
  }
  if (poller_.joinable()) poller_.join();
  close(ring_fd_);
  ring_fd_ = -1;
  if (sq_ring_ != nullptr) munmap(sq_ring_, sq_ring_sz_);
  if (cq_ring_ != nullptr) munmap(cq_ring_, cq_ring_sz_);
  if (sqes_ != nullptr) munmap(sqes_, sqes_sz_);
  if (buf_ring_ != nullptr) munmap(buf_ring_, buf_ring_sz_);
  if (buf_base_ != nullptr)
    munmap(buf_base_, (size_t)kNumBufs * kBufSize);
  if (send_base_ != nullptr)
    munmap(send_base_, (size_t)kNumSendBufs * kSendBufSize);
  sq_ring_ = cq_ring_ = nullptr;
  sqes_ = nullptr;
  buf_ring_ = nullptr;
  buf_base_ = send_base_ = nullptr;
}

struct io_uring_sqe* RingListener::get_sqe_locked() {
  unsigned head = sq_head_->load(std::memory_order_acquire);
  unsigned tail = sq_tail_->load(std::memory_order_relaxed);
  if (tail - head >= *sq_mask_ + 1) return nullptr;  // SQ full
  struct io_uring_sqe* sqe = &sqes_[tail & *sq_mask_];
  sq_array_[tail & *sq_mask_] = tail & *sq_mask_;
  return sqe;
}

void RingListener::flush_unsubmitted_locked() {
  // SQPOLL: the kernel poller consumes published SQEs by itself — the
  // only syscall needed is a wakeup when it idled out (NEED_WAKEUP).
  // This is the ~zero-syscall steady state: under load the flag stays
  // clear and submission is the tail store alone.
  if (sqpoll_) {
    unsubmitted_ = 0;
    if (sq_flags_->load(std::memory_order_acquire) &
        IORING_SQ_NEED_WAKEUP) {
      sys_enter(ring_fd_, 0, 0, IORING_ENTER_SQ_WAKEUP);
    }
    return;
  }
  // EINTR/EAGAIN/EBUSY must not strand published SQEs: unsubmitted_
  // carries leftovers; the poller also flushes each iteration so a
  // stranded SQE never waits for the next submission.
  while (unsubmitted_ > 0) {
    int rc = sys_enter(ring_fd_, unsubmitted_, 0, 0);
    if (rc > 0) {
      unsubmitted_ -= ((unsigned)rc > unsubmitted_ ? unsubmitted_
                                                   : (unsigned)rc);
      continue;
    }
    if (rc == 0) break;
    if (errno == EINTR) continue;
    break;  // EAGAIN/EBUSY: CQ pressure; retried after the next drain
  }
}

void RingListener::submit_locked() {
  unsigned tail = sq_tail_->load(std::memory_order_relaxed);
  sq_tail_->store(tail + 1, std::memory_order_release);
  unsubmitted_++;
  flush_unsubmitted_locked();
}

int RingListener::register_file(int fd, uint32_t* gen_out) {
  // files_mu_ is held across the kernel update AND gen read so a stale
  // rearm/send (which also takes files_mu_) can never interleave with
  // re-registration of a recycled slot.
  std::lock_guard g(files_mu_);
  int idx;
  if (!free_files_.empty()) {
    idx = free_files_.back();
    free_files_.pop_back();
  } else {
    if (next_file_ >= kMaxFiles) return -1;  // table spent: epoll lane
    idx = (int)next_file_++;
  }
  if (file_gen_.size() <= (size_t)idx) file_gen_.resize(idx + 1, 0);
  struct io_uring_files_update upd;
  memset(&upd, 0, sizeof(upd));
  upd.offset = (unsigned)idx;
  upd.fds = (uint64_t)(uintptr_t)&fd;
  if (sys_register(ring_fd_, IORING_REGISTER_FILES_UPDATE, &upd, 1) < 0) {
    free_files_.push_back(idx);
    return -1;
  }
  if (gen_out != nullptr) *gen_out = file_gen_[idx];
  return idx;
}

void RingListener::unregister_file(int file_index) {
  std::lock_guard g(files_mu_);
  int minus_one = -1;
  struct io_uring_files_update upd;
  memset(&upd, 0, sizeof(upd));
  upd.offset = (unsigned)file_index;
  upd.fds = (uint64_t)(uintptr_t)&minus_one;
  sys_register(ring_fd_, IORING_REGISTER_FILES_UPDATE, &upd, 1);
  if (file_gen_.size() <= (size_t)file_index) {
    file_gen_.resize(file_index + 1, 0);
  }
  file_gen_[file_index]++;  // invalidates in-flight rearms/sends
  free_files_.push_back(file_index);
}

bool RingListener::rearm_recv(int file_index, uint32_t gen, uint64_t tag) {
  std::lock_guard fg(files_mu_);
  if ((size_t)file_index >= file_gen_.size() ||
      file_gen_[file_index] != gen) {
    return false;  // slot recycled under us: caller demotes
  }
  std::lock_guard g(sq_mu_);
  struct io_uring_sqe* sqe = get_sqe_locked();
  if (sqe == nullptr) return false;
  memset(sqe, 0, sizeof(*sqe));
  sqe->opcode = IORING_OP_RECV;
  sqe->fd = file_index;
  sqe->flags = IOSQE_FIXED_FILE | IOSQE_BUFFER_SELECT;
  sqe->ioprio = IORING_RECV_MULTISHOT;
  sqe->buf_group = 0;
  sqe->user_data = make_recv_ud(tag);
  submit_locked();
  return true;
}

char* RingListener::acquire_send_buffer(uint16_t* buf_out) {
  std::lock_guard g(send_mu_);
  if (send_free_.empty()) return nullptr;
  *buf_out = send_free_.back();
  send_free_.pop_back();
  return send_base_ + (size_t)*buf_out * kSendBufSize;
}

void RingListener::release_send_buffer(uint16_t buf) {
  std::lock_guard g(send_mu_);
  send_free_.push_back(buf);
}

bool RingListener::submit_send(int file_index, uint32_t gen, uint64_t tag,
                               uint16_t buf, size_t len) {
  std::lock_guard fg(files_mu_);
  if ((size_t)file_index >= file_gen_.size() ||
      file_gen_[file_index] != gen) {
    release_send_buffer(buf);
    return false;  // slot recycled under us: caller demotes
  }
  {
    std::lock_guard g(send_mu_);
    send_tag_[buf] = tag;  // full 64-bit id rides the tag table
  }
  char* dst = send_base_ + (size_t)buf * kSendBufSize;
  std::lock_guard g(sq_mu_);
  struct io_uring_sqe* sqe = get_sqe_locked();
  if (sqe == nullptr) {
    release_send_buffer(buf);
    return false;
  }
  memset(sqe, 0, sizeof(*sqe));
  // WRITE_FIXED consumes the registered buffer by index — the kernel
  // skips the per-op page pinning OP_SEND would do.
  sqe->opcode = IORING_OP_WRITE_FIXED;
  sqe->fd = file_index;
  sqe->flags = IOSQE_FIXED_FILE;
  sqe->addr = (uint64_t)(uintptr_t)dst;
  sqe->len = (uint32_t)len;
  sqe->buf_index = buf;
  sqe->user_data = make_send_ud(buf);
  submit_locked();
  return true;
}

void RingListener::recycle_buffer(uint16_t buf_id) {
  std::lock_guard g(buf_mu_);
  struct nat_pbuf_entry* b = ring_entry(buf_ring_tail_ & buf_mask_);
  b->addr = (uint64_t)(uintptr_t)(buf_base_ + (size_t)buf_id * kBufSize);
  b->len = kBufSize;
  b->bid = buf_id;
  buf_ring_tail_++;
  ring_tail_atomic()->store(buf_ring_tail_, std::memory_order_release);
}

void RingListener::recycle_send_buffer(uint16_t idx) {
  std::lock_guard g(send_mu_);
  send_free_.push_back(idx);
}

void RingListener::poller_loop() {
  while (!stop_.load(std::memory_order_acquire)) {
    {
      // flush SQEs stranded by EAGAIN/EBUSY on the submit path
      std::lock_guard g(sq_mu_);
      flush_unsubmitted_locked();
    }
    int rc = sys_enter(ring_fd_, 0, 1, IORING_ENTER_GETEVENTS);
    if (rc < 0 && errno != EINTR && errno != EAGAIN && errno != EBUSY) {
      break;
    }
    unsigned head = cq_head_->load(std::memory_order_relaxed);
    unsigned tail = cq_tail_->load(std::memory_order_acquire);
    bool got = false;
    while (head != tail) {
      struct io_uring_cqe* cqe = &cqes_[head & *cq_mask_];
      uint64_t ud = cqe->user_data;
      RingCompletion c;
      c.tag = ud_tag(ud);
      c.kind = (int)ud_kind(ud);
      c.res = cqe->res;
      c.more = (cqe->flags & IORING_CQE_F_MORE) != 0;
      if (c.kind == (int)kKindRecv
          && (cqe->flags & IORING_CQE_F_BUFFER)) {
        c.buf_id = (uint16_t)(cqe->flags >> IORING_CQE_BUFFER_SHIFT);
      }
      if (c.kind == (int)kKindSend) {
        c.send_buf = ud_aux(ud);
        {
          std::lock_guard g(send_mu_);
          c.tag = send_tag_[c.send_buf];
        }
        n_send_.fetch_add(1, std::memory_order_relaxed);
      } else if (c.kind == (int)kKindRecv) {
        n_recv_.fetch_add(1, std::memory_order_relaxed);
      }
      head++;
      if (c.kind <= 1) {
        std::lock_guard g(comp_mu_);
        comp_q_.push_back(c);
        got = true;
      }
    }
    cq_head_->store(head, std::memory_order_release);
    if (got) {
      bool drained = false;
      if (drain_fn_) {
        drained = drain_fn_();  // inline on the poller (no handoff)
      }
      if (!drained && wake_fn_) {
        // natfault doorbell site: a dropped wake must only cost latency
        // (the idle-hook drain and the next harvest recover), never a
        // lost completion
        NatFaultAct fda = NAT_FAULT_POINT(NF_DOORBELL);
        if (fda.action == NF_DELAY) nat_fault_delay_ms(fda.delay_ms);
        if (fda.action != NF_DROP) {
          wake_fn_();  // skipped/unset: unpark a worker to drain
        }
      }
    }
  }
}

}  // namespace brpc_tpu
