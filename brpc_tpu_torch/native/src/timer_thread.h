// TimerThread — native counterpart of bthread's TimerThread
// (/root/reference/src/bthread/timer_thread.h:32-90): schedule() pushes
// into one of several staged buckets (hashed by id, spreading producer
// contention exactly as the reference's 13 buckets do); a dedicated runner
// thread drains the buckets into its private min-heap and fires due tasks.
// Cancellation is lazy (unschedule marks the id; fire skips it) — the RPC
// timeout path doesn't even unschedule: a completed call's fire loses the
// pending-bit CAS and is a no-op.
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <queue>
#include <thread>
#include <unordered_set>
#include <vector>
#include "nat_lockrank.h"

namespace brpc_tpu {

class TimerThread {
 public:
  using TimerFn = void (*)(void*);

  static TimerThread* instance();

  // Schedule fn(arg) to run ~delay_ms from now on the timer thread.
  // fn must not block. Returns a nonzero timer id.
  uint64_t schedule(TimerFn fn, void* arg, int64_t delay_ms);

  // Best-effort cancel. True = the task will not fire (it had not fired
  // yet); false = it already fired or is firing.
  bool unschedule(uint64_t id);

  void start();
  void stop();

 private:
  struct Entry {
    int64_t when_us;
    uint64_t id;
    TimerFn fn;
    void* arg;
    bool operator>(const Entry& o) const { return when_us > o.when_us; }
  };

  static const int kBuckets = 8;
  struct Bucket {
    NatMutex<kLockRankTimerBucket> bucket_mu;
    std::vector<Entry> staged;
  };

  void run();

  Bucket buckets_[kBuckets];
  std::atomic<uint64_t> next_id_{1};
  std::atomic<int64_t> nearest_us_{INT64_MAX};

  std::mutex run_mu_;  // natcheck:rank(timer.run, 86) — run_cv_ partner
  std::condition_variable run_cv_;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry>> heap_;

  NatMutex<kLockRankTimerCancel> cancel_mu_;
  std::unordered_set<uint64_t> cancelled_;

  std::thread thread_;
  std::atomic<bool> stop_{false};
  std::atomic<bool> started_{false};
  NatMutex<kLockRankTimerStart> start_mu_;
};

}  // namespace brpc_tpu
