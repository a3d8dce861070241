// WorkStealingQueue — lock-free Chase-Lev deque.
//
// Native counterpart of bthread::WorkStealingQueue
// (/root/reference/src/bthread/work_stealing_queue.h:31-157): owner pushes
// and pops the bottom; thieves CAS the top. Power-of-two ring, acquire/
// release fences per the Chase-Lev/Le et al. formulation.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <vector>

#include "nat_atomic.h"

template <typename T>
class WorkStealingQueue {
 public:
  explicit WorkStealingQueue(size_t capacity = 4096)
      : cap_(round_up_pow2(capacity)), mask_(cap_ - 1), buf_(cap_),
        top_(0), bottom_(0) {}

  // Owner only.
  bool push(T item) {
    uint64_t b = bottom_.load(std::memory_order_relaxed);
    uint64_t t = top_.load(std::memory_order_acquire);
    if (b - t >= cap_) return false;  // full
    buf_[b & mask_] = item;
    bottom_.store(b + 1, std::memory_order_release);
    return true;
  }

  // Owner only: LIFO pop.
  bool pop(T* out) {
    uint64_t b = bottom_.load(std::memory_order_relaxed);
    uint64_t t = top_.load(std::memory_order_relaxed);
    if (t >= b) return false;
    b -= 1;
    bottom_.store(b, std::memory_order_relaxed);
    nat::atomic_thread_fence(std::memory_order_seq_cst);
    t = top_.load(std::memory_order_relaxed);
    if (t > b) {  // emptied by a thief
      bottom_.store(b + 1, std::memory_order_relaxed);
      return false;
    }
    *out = buf_[b & mask_];
    if (t == b) {  // last element: race the thief for it
      if (!top_.compare_exchange_strong(t, t + 1,
                                        std::memory_order_seq_cst,
                                        std::memory_order_relaxed)) {
        bottom_.store(b + 1, std::memory_order_relaxed);
        return false;
      }
      bottom_.store(b + 1, std::memory_order_relaxed);
    }
    return true;
  }

  // Any thread: FIFO steal.
  bool steal(T* out) {
    uint64_t t = top_.load(std::memory_order_acquire);
    nat::atomic_thread_fence(std::memory_order_seq_cst);
    uint64_t b = bottom_.load(std::memory_order_acquire);
    if (t >= b) return false;
    T item = buf_[t & mask_];
    if (!top_.compare_exchange_strong(t, t + 1, std::memory_order_seq_cst,
                                      std::memory_order_relaxed)) {
      return false;  // lost the race; caller retries elsewhere
    }
    *out = item;
    return true;
  }

  size_t volatile_size() const {
    uint64_t b = bottom_.load(std::memory_order_relaxed);
    uint64_t t = top_.load(std::memory_order_relaxed);
    return b > t ? (size_t)(b - t) : 0;
  }

 private:
  static size_t round_up_pow2(size_t v) {
    size_t r = 1;
    while (r < v) r <<= 1;
    return r;
  }
  size_t cap_, mask_;
  std::vector<T> buf_;
  nat::atomic<uint64_t> top_, bottom_;
};
