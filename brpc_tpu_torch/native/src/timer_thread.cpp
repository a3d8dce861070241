#include "timer_thread.h"

#include "scheduler.h"  // nat_cv_wait_for

#include <chrono>

namespace brpc_tpu {

static int64_t now_us() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

TimerThread* TimerThread::instance() {
  // natcheck:leak(TimerThread::instance): a static object's destructor
  // would run ~thread on a joinable thread at exit (std::terminate);
  // process-lifetime like the reference's timer thread
  static TimerThread* t = new TimerThread();
  return t;
}

void TimerThread::start() {
  std::lock_guard g(start_mu_);
  if (started_.load(std::memory_order_acquire)) return;
  stop_.store(false, std::memory_order_relaxed);
  thread_ = std::thread([this] { run(); });
  started_.store(true, std::memory_order_release);
}

void TimerThread::stop() {
  std::lock_guard g(start_mu_);
  if (!started_.load(std::memory_order_acquire)) return;
  stop_.store(true, std::memory_order_release);
  run_cv_.notify_all();
  // natcheck:allow(lock-switch): start_mu_ serializes start/stop and the
  // runner never takes it — joining under it cannot deadlock (cold path)
  if (thread_.joinable()) thread_.join();
  started_.store(false, std::memory_order_release);
}

uint64_t TimerThread::schedule(TimerFn fn, void* arg, int64_t delay_ms) {
  if (!started_.load(std::memory_order_acquire)) start();
  uint64_t id = next_id_.fetch_add(1, std::memory_order_relaxed);
  Entry e{now_us() + delay_ms * 1000, id, fn, arg};
  Bucket& b = buckets_[id % kBuckets];
  {
    std::lock_guard g(b.bucket_mu);
    b.staged.push_back(e);
  }
  // earlier-than-known deadline: poke the runner so it re-sleeps
  int64_t nearest = nearest_us_.load(std::memory_order_acquire);
  while (e.when_us < nearest) {
    if (nearest_us_.compare_exchange_weak(nearest, e.when_us,
                                          std::memory_order_acq_rel)) {
      // lock-then-notify pairs with the runner's locked recheck of
      // nearest_us_, so a wake between its recheck and its wait is
      // never lost
      { std::lock_guard g(run_mu_); }
      run_cv_.notify_one();
      break;
    }
  }
  return id;
}

bool TimerThread::unschedule(uint64_t id) {
  std::lock_guard g(cancel_mu_);
  return cancelled_.insert(id).second;
}

void TimerThread::run() {
  while (!stop_.load(std::memory_order_acquire)) {
    // drain the staged buckets into the private heap
    for (Bucket& b : buckets_) {
      std::lock_guard g(b.bucket_mu);
      for (Entry& e : b.staged) heap_.push(e);
      b.staged.clear();
    }
    int64_t now = now_us();
    while (!heap_.empty() && heap_.top().when_us <= now) {
      Entry e = heap_.top();
      heap_.pop();
      bool skip = false;
      {
        std::lock_guard g(cancel_mu_);
        skip = cancelled_.erase(e.id) > 0;
      }
      if (!skip) e.fn(e.arg);
    }
    int64_t next = heap_.empty() ? INT64_MAX : heap_.top().when_us;
    nearest_us_.store(next, std::memory_order_release);
    std::unique_lock lk(run_mu_);
    if (stop_.load(std::memory_order_acquire)) break;
    if (nearest_us_.load(std::memory_order_acquire) < next) {
      continue;  // an earlier timer landed while we were unlocked
    }
    int64_t wait_us = next == INT64_MAX ? 100000 : next - now_us();
    if (wait_us > 100000) wait_us = 100000;  // re-scan staged periodically
    if (wait_us > 0) {
      nat_cv_wait_for(run_cv_, lk, std::chrono::microseconds(wait_us));
    }
  }
}

}  // namespace brpc_tpu
