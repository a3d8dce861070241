// C API for the native core — consumed by brpc_tpu/native via ctypes.
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>

#include "iobuf.h"
#include "nat_api.h"
#include "rpc_meta.h"
#include "scheduler.h"

using namespace brpc_tpu;

extern "C" {

// ---- scheduler ----

int nat_sched_start(int nworkers) {
  return Scheduler::instance()->start(nworkers);
}

void nat_sched_stop() { Scheduler::instance()->stop(); }

int nat_sched_workers() { return Scheduler::instance()->nworkers(); }

uint64_t nat_sched_switches() {
  return Scheduler::instance()->total_switches();
}

// spawn N fibers each incrementing a shared counter M times with yields;
// returns the final counter (correctness probe for spawn/steal/yield).
static std::atomic<uint64_t> g_counter{0};
struct CountArg {
  int rounds;
};
static void count_fiber(void* a) {
  CountArg* ca = (CountArg*)a;
  for (int i = 0; i < ca->rounds; i++) {
    g_counter.fetch_add(1, std::memory_order_relaxed);
    if ((i & 15) == 0) Scheduler::yield();
  }
}

uint64_t nat_bench_spawn_join(int nfibers, int rounds) {
  g_counter.store(0, std::memory_order_relaxed);
  std::vector<Fiber*> fibers;
  CountArg arg{rounds};
  for (int i = 0; i < nfibers; i++) {
    fibers.push_back(Scheduler::instance()->spawn(count_fiber, &arg));
  }
  for (Fiber* f : fibers) Scheduler::instance()->join(f);
  return g_counter.load(std::memory_order_relaxed);
}

// ping-pong: two fibers alternating through butexes
// (bthread_ping_pong_unittest shape); returns ns per round-trip.
struct PingPongArg {
  Butex* a;
  Butex* b;
  int rounds;
  bool is_ping;
};
static void ping_pong_fiber(void* p) {
  PingPongArg* arg = (PingPongArg*)p;
  // the fetch_adds below are butex WAKE-PROTOCOL value bumps, not
  // reference counts — they are outside the NAT_REF_* ownership surface
  // (tools/natcheck refown) by design
  for (int i = 0; i < arg->rounds; i++) {
    if (arg->is_ping) {
      arg->b->value.fetch_add(1, std::memory_order_release);
      Scheduler::butex_wake(arg->b, 1);
      Scheduler::butex_wait(arg->a, i);
    } else {
      Scheduler::butex_wait(arg->b, i);
      arg->a->value.fetch_add(1, std::memory_order_release);
      Scheduler::butex_wake(arg->a, 1);
    }
  }
}

double nat_bench_ping_pong(int rounds) {
  Butex a, b;
  PingPongArg ping{&a, &b, rounds, true};
  PingPongArg pong{&a, &b, rounds, false};
  auto t0 = std::chrono::steady_clock::now();
  Fiber* f1 = Scheduler::instance()->spawn(ping_pong_fiber, &ping);
  Fiber* f2 = Scheduler::instance()->spawn(ping_pong_fiber, &pong);
  Scheduler::instance()->join(f1);
  Scheduler::instance()->join(f2);
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / rounds;
}

// ---- self tests (return 0 on success) ----

int nat_wsq_selftest() {
  WorkStealingQueue<int> q(64);
  for (int i = 0; i < 50; i++) {
    if (!q.push(i)) return 1;
  }
  int v;
  if (!q.pop(&v) || v != 49) return 2;   // owner LIFO
  if (!q.steal(&v) || v != 0) return 3;  // thief FIFO
  int count = 2;
  while (q.pop(&v)) count++;
  if (count != 50) return 4;
  return 0;
}

int nat_iobuf_selftest() {
  IOBuf a;
  a.append("hello ", 6);
  a.append("world", 5);
  if (a.length() != 11) return 1;
  IOBuf b;
  a.cut_into(&b, 6);
  if (b.to_string() != "hello " || a.to_string() != "world") return 2;
  IOBuf c(b);  // ref-sharing copy
  if (c.to_string() != "hello ") return 3;
  std::string big(100000, 'z');
  IOBuf d;
  d.append(big);
  if (d.length() != big.size() || d.to_string() != big) return 4;
  d.pop_front(99999);
  if (d.length() != 1) return 5;
  // arena-backed user blocks: foreign memory rides the IOBuf zero-copy;
  // the release action fires exactly once, on the LAST ref drop
  static int user_frees = 0;
  user_frees = 0;
  std::string arena(70000, 'u');
  {
    IOBuf e;
    e.append("hdr:", 4);
    e.append_user(arena.data(), arena.size(),
                  [](void*) { user_frees++; }, nullptr);
    if (e.length() != 4 + arena.size()) return 6;
    IOBuf f;
    e.cut_into(&f, 40000);  // split mid-user-block: shared refs
    if (user_frees != 0) return 7;
    if (f.to_string() != "hdr:" + arena.substr(0, 39996)) return 8;
    f.clear();
    if (user_frees != 0) return 9;  // e still holds the tail ref
  }
  if (user_frees != 1) return 10;
  return 0;
}

int nat_meta_selftest() {
  RpcMetaN m;
  m.has_request = true;
  m.request.service_name = "EchoService";
  m.request.method_name = "Echo";
  m.correlation_id = 12345678901LL;
  m.attachment_size = 42;
  std::string enc = encode_request_meta(m);
  RpcMetaN out;
  if (!decode_meta(enc.data(), enc.size(), &out)) return 1;
  if (!out.has_request || out.request.service_name != "EchoService" ||
      out.request.method_name != "Echo" ||
      out.correlation_id != 12345678901LL || out.attachment_size != 42)
    return 2;
  RpcMetaN r;
  r.has_response = true;
  r.response.error_code = 1008;
  r.response.error_text = "rpc timed out";
  r.correlation_id = 7;
  std::string enc2 = encode_response_meta(r);
  RpcMetaN out2;
  if (!decode_meta(enc2.data(), enc2.size(), &out2)) return 3;
  if (!out2.has_response || out2.response.error_code != 1008 ||
      out2.response.error_text != "rpc timed out" ||
      out2.correlation_id != 7)
    return 4;
  return 0;
}

}  // extern "C"
