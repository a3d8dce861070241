// nat_api — the complete extern "C" surface of libbrpc_tpu_native.so.
//
// Single source of truth for the FFI contract: every .cpp that DEFINES one
// of these functions includes this header, so a drifting definition is a
// compile error in that TU instead of a silent ABI break discovered by a
// crashing ctypes call. tools/natcheck's ABI pass closes the other half of
// the loop: native/src/nat_abi.cpp stringifies each declaration below into
// a manifest (sizeof/offsetof/arg types) that is cross-checked against the
// ctypes argtypes/restype declarations in brpc_tpu/native/__init__.py, and
// `nm -D` of the built .so is diffed against the manifest so an export
// added without a declaration here fails `make -C native check`.
#pragma once

#include <stddef.h>
#include <stdint.h>

// wire-origin marker for the wiretrust taint pass (grammar documented in
// nat_internal.h); defined in the lowest common header so every TU that
// parses wire bytes can annotate without pulling in the internals
#ifndef NAT_WIRE
#define NAT_WIRE(x) (x)
#endif

namespace brpc_tpu {
struct NatSpanRec;        // full layout in nat_stats.h (mirrored in ctypes)
struct NatMethodStatRow;  // per-method stats snapshot row (nat_stats.h)
struct NatConnRow;        // native /connections snapshot row (nat_stats.h)
struct NatLockRankRow;    // per-rank lock-wait totals row (nat_stats.h)
struct NatDumpStatusRec;  // flight-recorder status snapshot (nat_dump.h)
struct NatReplayResult;   // replay run result (nat_dump.h)
struct NatClusterRow;     // per-backend cluster snapshot row (nat_stats.h)
struct NatResRow;         // per-subsystem resource-accounting row (nat_res.h)
}

extern "C" {

// ---- async-call callback shapes (ctypes CFUNCTYPE mirrors) ----
// tpu_std channel done-closure: cb(arg, error_code, resp, resp_len)
typedef void (*nat_acall_cb)(void* arg, int32_t error_code, const char* resp,
                             size_t resp_len);
// HTTP/gRPC client lanes add an aux status (HTTP status / grpc-status)
typedef void (*nat_acall2_cb)(void* arg, int32_t error_code,
                              int32_t aux_status, const char* resp,
                              size_t resp_len);

// ---- scheduler + selftests (api.cpp) ----
int nat_sched_start(int nworkers);
void nat_sched_stop(void);
int nat_sched_workers(void);
uint64_t nat_sched_switches(void);
uint64_t nat_bench_spawn_join(int nfibers, int rounds);
double nat_bench_ping_pong(int rounds);
int nat_wsq_selftest(void);
int nat_iobuf_selftest(void);
int nat_meta_selftest(void);

// ---- minimal epoll echo runtime (echo_runtime.cpp) ----
int nat_echo_server_start(const char* ip, int port);
void nat_echo_server_stop(void);
uint64_t nat_echo_server_requests(void);
double nat_echo_client_bench(const char* ip, int port, int nconn,
                             double seconds, int payload_size, int pipeline,
                             uint64_t* out_requests);

// ---- IOBuf syscall counters (iobuf.cpp) ----
void nat_io_counters(uint64_t* wc, uint64_t* wb, uint64_t* rc, uint64_t* rb);

// ---- native RPC runtime: server side (nat_server.cpp) ----
int nat_rpc_set_dispatchers(int n);
int nat_rpc_server_start(const char* ip, int port, int nworkers,
                         int enable_native_echo);
void nat_rpc_server_stop(void);
int nat_rpc_server_enable_raw_fallback(int enable);
int nat_rpc_server_native_http(int enable);
int nat_rpc_server_redis(int mode);
uint64_t nat_rpc_server_requests(void);
uint64_t nat_rpc_server_connections(void);
int nat_rpc_use_io_uring(int enable);
void nat_ring_counters(uint64_t* recv_out, uint64_t* send_out);
// multicore observability: per-dispatcher rows (sockets owned right now,
// epoll rounds that delivered events, SQPOLL on the loop's ring:
// -1 = no ring). Returns -1 for an out-of-range index.
int nat_disp_count(void);
int nat_disp_stat(int idx, uint64_t* sockets_out, uint64_t* wakeups_out,
                  int* sqpoll_out);

// py-lane request handoff
void* nat_take_request(int timeout_ms);
int nat_take_request_batch(void** out, int max, int timeout_ms);
int32_t nat_req_kind(void* h);
const char* nat_req_field(void* h, int which, size_t* len);
int64_t nat_req_cid(void* h);
uint64_t nat_req_aux(void* h);
int32_t nat_req_compress(void* h);
uint64_t nat_req_sock_id(void* h);
void nat_req_free(void* h);
int nat_respond(void* h, int32_t error_code, const char* error_text,
                const char* payload, size_t payload_len, const char* att,
                size_t att_len);
int nat_sock_write(uint64_t sock_id, const char* data, size_t len);
int nat_sock_set_failed(uint64_t sock_id);

// protocol-lane response emitters (nat_http.cpp / nat_h2.cpp / nat_redis.cpp)
int nat_http_respond(uint64_t sock_id, int64_t seq, const char* data,
                     size_t len, int close_after);
int nat_sock_graceful_close(uint64_t sock_id);
int nat_grpc_respond(uint64_t sock_id, int64_t sid, const char* payload,
                     size_t payload_len, int grpc_status,
                     const char* grpc_message);
int nat_redis_respond(uint64_t sock_id, int64_t seq, const char* data,
                      size_t len);

// TLS on the native port (nat_ssl.cpp)
int nat_rpc_server_ssl(const char* cert_path, const char* key_path);

// Multi-port listening on the RUNNING native server (the swarm-backend
// seam: one process serves N ports, each port a distinct LB backend).
// add_port binds+listens and shards the listener across the dispatcher
// pool; returns the bound port (or -1). remove_port unregisters a
// listener added this way (its accepted connections keep serving).
// Every extra port tears down with the server (stop/quiesce).
int nat_rpc_server_add_port(const char* ip, int port);
int nat_rpc_server_remove_port(int port);

// ---- native fan-out cluster (nat_cluster.cpp / nat_lb.cpp) ----
// A C++ cluster: DoublyBufferedData server list (zero-lock LB reads),
// the LB zoo (lb_policy: rr / wrr / random / wr / la / c_hash aliases
// c_murmurhash,c_md5), per-backend lazily-dialed NatChannels with
// circuit breakers + lame-duck detach, and the combo-channel verbs.
// The naming feed (nat_cluster_update) takes the FULL resolved list
// "ip:port[ weight[ tag]]" separated by ';'/','/newlines each refresh.
void* nat_cluster_create(const char* lb_policy, int connect_timeout_ms,
                         int health_check_ms, int enable_breaker);
void nat_cluster_close(void* h);
int nat_cluster_update(void* h, const char* servers);
int nat_cluster_backend_count(void* h);
int nat_cluster_select_debug(void* h, uint64_t request_code, char* ep_out,
                             size_t cap);
// SelectiveChannel verb: LB-pick + failover retry (exclusion set);
// timeout covers all attempts; request_code keys consistent hashing.
int nat_cluster_call(void* h, const char* service, const char* method,
                     const char* payload, size_t payload_len,
                     int timeout_ms, int max_retry, uint64_t request_code,
                     char** resp_out, size_t* resp_len,
                     char** err_text_out);
// ParallelChannel verb: fan to every backend on fibers, merge the
// successful responses natively in backend order (concatenation ==
// protobuf MergeFrom); fails when failed sub-calls reach fail_limit
// (<= 0 = all). failed_out reports the failed sub-call count.
int nat_cluster_parallel_call(void* h, const char* service,
                              const char* method, const char* payload,
                              size_t payload_len, int timeout_ms,
                              int fail_limit, char** resp_out,
                              size_t* resp_len, char** err_text_out,
                              int* failed_out);
// PartitionChannel verb: one sub-call per "i/n" partition group
// (partitions = n; 0 = largest scheme present), merged in partition
// order; an empty partition counts as a failed sub-call.
int nat_cluster_partition_call(void* h, const char* service,
                               const char* method, const char* payload,
                               size_t payload_len, int timeout_ms,
                               int partitions, int fail_limit,
                               char** resp_out, size_t* resp_len,
                               char** err_text_out, int* failed_out);
// DynamicPartitionChannel verb: the partition count is picked PER CALL
// from the live version's "i/n" totals, weighted by usable capacity
// (_dynpart LB), then fanned one sub-call per group like
// partition_call. A resize (naming update changing the scheme layout)
// is never caller-visible: in-flight fans complete against their
// pinned version. scheme_out reports the chosen part_total.
int nat_cluster_dynpart_call(void* h, const char* service,
                             const char* method, const char* payload,
                             size_t payload_len, int timeout_ms,
                             int fail_limit, char** resp_out,
                             size_t* resp_len, char** err_text_out,
                             int* failed_out, int* scheme_out);
// Dynpart equivalence probe: dump the live scheme table (ascending
// part_total + usable capacity, up to max_schemes rows) and the scheme
// the weighted walk picks for the caller-supplied point x01 in [0,1).
// Returns the scheme count.
int nat_cluster_dynpart_debug(void* h, double x01, int* totals_out,
                              int* caps_out, int max_schemes,
                              int* chosen_out);
int nat_cluster_stats(void* h, brpc_tpu::NatClusterRow* out, int max);
// Fan-out bench loop: mode 0 = selective (param = max_retry), 1 =
// parallel (param = fail_limit), 2 = dynpart (param = fail_limit);
// `concurrency` pthreads for `seconds`.
// Returns verb qps; out_p99_us = verb-latency p99.
double nat_cluster_bench(void* h, int mode, const char* service,
                         const char* method, const char* payload,
                         size_t payload_len, int timeout_ms, int param,
                         double seconds, int concurrency,
                         uint64_t* out_calls, uint64_t* out_failed,
                         double* out_p99_us);

// ---- overload protection: native server admission control
// (nat_overload.cpp) ----
// limiter spec: "" / "none" / "0" = off, "auto" = gradient limiter,
// "constant:N" or "N" = fixed max in-flight work requests. Rejections
// answer ELIMIT(2004) / HTTP 503 / gRPC RESOURCE_EXHAUSTED on the wire.
int nat_rpc_server_limiter(const char* spec);
int nat_rpc_server_queue_deadline_ms(int ms);
int nat_rpc_server_inflight(void);
int nat_rpc_server_limit(void);

// ---- graceful quiesce/drain lifecycle (nat_quiesce.cpp) ----
// Three-phase Server::Stop(timeout): stop accepting, lame-duck every
// connection per protocol (h2 GOAWAY, HTTP Connection: close, tpu_std
// SHUTDOWN meta bit, RESP close-after-reply), drain admitted work under
// the deadline with ELIMIT/503 rejections for new arrivals, close
// sockets only once flushed. 0 = drained clean, 1 = deadline expired
// (stragglers 503'd), -1 = no running server.
int nat_server_quiesce(int timeout_ms);
int nat_server_draining(void);

// ---- deterministic fault injection (nat_fault.cpp) ----
// spec grammar in nat_fault.h; also armed from the NAT_FAULT env var at
// library load. NULL/"" clears. Same seed => same fault schedule.
int nat_fault_configure(const char* spec);
int nat_fault_enabled(void);
uint64_t nat_fault_injected(void);

// ---- native RPC runtime: client side (nat_channel.cpp / nat_client.cpp) ----
void* nat_channel_open(const char* ip, int port, int nworkers,
                       int batch_writes, int connect_timeout_ms,
                       int health_check_ms);
void* nat_channel_open_proto(const char* ip, int port, int nworkers,
                             int batch_writes, int connect_timeout_ms,
                             int health_check_ms, int protocol,
                             const char* authority);
void nat_channel_close(void* h);
int nat_channel_call(void* h, const char* service, const char* method,
                     const char* payload, size_t payload_len, int timeout_ms,
                     char** resp_out, size_t* resp_len, char** err_text_out);
int nat_channel_call_full(void* h, const char* service, const char* method,
                          const char* payload, size_t payload_len,
                          int timeout_ms, int max_retry, int backup_ms,
                          char** resp_out, size_t* resp_len,
                          char** err_text_out);
int nat_channel_acall(void* h, const char* service, const char* method,
                      const char* payload, size_t payload_len, int timeout_ms,
                      nat_acall_cb cb, void* arg);
void nat_buf_free(char* p);
// circuit breaker (two-EMA-window isolation mirroring
// brpc_tpu/rpc/circuit_breaker.py) + channel-wide retry budget
int nat_channel_set_breaker(void* h, int enable);
int nat_channel_breaker_state(void* h);
int nat_channel_retry_budget(void* h);
int nat_http_call(void* h, const char* verb, const char* path,
                  const char* extra_headers, const char* body,
                  size_t body_len, int timeout_ms, int* status_out,
                  char** resp_out, size_t* resp_len);
int nat_http_acall(void* h, const char* verb, const char* path,
                   const char* extra_headers, const char* body,
                   size_t body_len, int timeout_ms, nat_acall2_cb cb,
                   void* arg);
int nat_grpc_call(void* h, const char* path, const char* payload,
                  size_t payload_len, int timeout_ms, int* grpc_status_out,
                  char** resp_out, size_t* resp_len, char** err_text_out);
int nat_grpc_acall(void* h, const char* path, const char* payload,
                   size_t payload_len, int timeout_ms, nat_acall2_cb cb,
                   void* arg);

// ---- bench clients (nat_bench.cpp) ----
double nat_rpc_client_bench(const char* ip, int port, int nconn,
                            int fibers_per_conn, double seconds,
                            int payload_size, uint64_t* out_requests);
double nat_rpc_client_bench_async(const char* ip, int port, int nconn,
                                  int window, double seconds,
                                  int payload_size, uint64_t* out_requests);
double nat_rpc_client_bench_bulk(const char* ip, int port, int att_bytes,
                                 double seconds, uint64_t* out_bytes);
double nat_http_client_bench(const char* ip, int port, int nconn,
                             int pipeline, double seconds, const char* path,
                             const char* body, size_t body_len,
                             const char* content_type,
                             uint64_t* out_requests);
double nat_grpc_client_bench(const char* ip, int port, int nconn, int window,
                             double seconds, const char* path,
                             const char* payload, size_t payload_len,
                             uint64_t* out_requests);
double nat_redis_client_bench(const char* ip, int port, int nconn,
                              int pipeline, double seconds,
                              uint64_t* out_requests);
double nat_grpc_channel_bench(const char* ip, int port, int nconn,
                              int window, double seconds, const char* path,
                              const char* payload, size_t payload_len,
                              uint64_t* out_requests);
double nat_http_channel_bench(const char* ip, int port, int nconn,
                              int window, double seconds, const char* path,
                              const char* body, size_t body_len,
                              uint64_t* out_requests);

// ---- shm usercode worker lane: zero-copy descriptor rings + blob
// arenas (nat_shm_lane.cpp) ----
int nat_shm_lane_create(size_t ring_bytes);
int nat_shm_lane_max_workers(void);
int nat_shm_lane_workers(void);
const char* nat_shm_lane_name(void);
int nat_shm_lane_enable(int enable);
int nat_shm_lane_set_timeout_ms(int ms);
// probe worker lifetime fences once; recover dead slots (the drainer
// does this continuously while the lane is enabled)
int nat_shm_lane_recover_probe(void);
// validate a candidate segment image (cross-process attach trust
// boundary: magic/version/slots/arena vs the claimed length) without
// mapping or attaching; 1 = attachable, 0 = rejected. Also the forged-
// segment fuzz seam.
int nat_shm_seg_validate(const void* mem, size_t len);
int nat_shm_worker_attach(const char* name);
void* nat_shm_take_request(int timeout_ms);
int nat_shm_respond(int kind, uint64_t sock_id, int64_t seq,
                    const char* payload, size_t payload_len, int32_t status,
                    const char* message, int close_after);
// bulk-tensor entry: stage bytes straight into a worker's blob arena and
// publish one kind-8 descriptor (the HostArena / device-lane staging
// seam); -1 = every ring full (caller owns backpressure policy)
int nat_shm_push_tensor(const char* data, size_t len, uint64_t tag);
// tensor fabric (ISSUE 15): a peer process claims a PRODUCER slot on the
// receiver's segment, pushes kind-8 records written ONCE into the shared
// blob arena, and the receiver takes them as out-of-order-releasable
// LEASES (nat_req_* handle; nat_req_free releases the span)
int nat_shm_producer_attach(const char* name);
int nat_shm_fabric_push(const char* data, size_t len, uint64_t tag);
void* nat_shm_fabric_take(int timeout_ms);
// transport microbenchmarks (bench.py shm_desc lanes): parent-side push
// loop (returns GB/s) and worker-side native drain loop (returns records)
double nat_shm_push_bench(size_t record_bytes, double seconds,
                          uint64_t* out_records);
uint64_t nat_shm_worker_drain_bench(int idle_exit_ms);

// ---- observability snapshot surface (nat_stats.cpp) ----
int nat_stats_counter_count(void);
uint64_t nat_stats_now_ns(void);
const char* nat_stats_counter_name(int id);
int nat_stats_counters(uint64_t* out, int max);
// Bump a native counter by NAME (Python-side controllers — the fleet
// autoscaler charges nat_autoscale_* here so its decisions land in the
// same /vars + /brpc_metrics surface as native events). Returns the
// counter id, or -1 for an unknown name.
int nat_stats_counter_bump(const char* name, uint64_t delta);
int nat_stats_lane_count(void);
const char* nat_stats_lane_name(int lane);
int nat_stats_hist_nbuckets(void);
int nat_stats_hist(int lane, uint64_t* out, int max);
double nat_stats_hist_quantile(int lane, double q);
void nat_stats_enable_spans(int every);
int nat_stats_drain_spans(brpc_tpu::NatSpanRec* out, int max);
void nat_stats_reset(void);
// thread-local trace context (rpcz stitching): client calls issued on
// this thread propagate (trace_id, span_id) on the wire — tpu_std meta
// trace fields, HTTP x-bd-trace-* headers, gRPC metadata and kind-8 shm
// descriptors. (0, 0) clears.
void nat_trace_set(uint64_t trace_id, uint64_t span_id);

// ---- native observatory (ISSUE 9) ----
// Per-method stats (details/method_status.h role): one row per
// (lane, method) recorded at the native-handler call sites + the shm
// worker emit path — qps source (count), errors, current/max
// concurrency; latency quantiles per method from log2 histograms.
int nat_method_stats(brpc_tpu::NatMethodStatRow* out, int max);
double nat_method_quantile(int lane, const char* method, double q);
// Raw log2 buckets for one method (lookup-only; -1 when absent): the
// mergeable form — a fleet collector sums buckets across processes and
// takes quantiles of the merged histogram (exact for log2 buckets),
// never averaging per-member percentiles.
int nat_method_hist(int lane, const char* method, uint64_t* out, int max);
// Versioned compact snapshot (JSON) for the builtin.stats endpoint:
// counters, per-lane + per-method raw log2 buckets, server
// overload/quiesce state, open client channels (breaker / lame-duck /
// retry budget), and the nat_res subsystem ledger. Caller frees *out
// with nat_buf_free.
int nat_stats_snapshot(char** out, size_t* out_len);
// Native /connections: one row per live socket (byte/message/syscall
// counters, unwritten bytes = write-stack depth, protocol, remote,
// owning dispatcher).
int nat_conn_snapshot(brpc_tpu::NatConnRow* out, int max);
// Lock-contention profiler: per-rank wait totals are always on (fed by
// every contended NatMutex acquisition); nat_mu_prof_start arms
// threshold/rate-decimated stack sampling (seeded, deterministic per
// thread) into per-tid rings reported as flat wait-us tables (mode 0)
// or collapsed stacks weighted by wait-us (mode 1), malloc'd (free
// with nat_buf_free).
int nat_mu_prof_start(int threshold_us, int every, uint64_t seed);
int nat_mu_prof_stop(void);
int nat_mu_prof_running(void);
uint64_t nat_mu_prof_samples(void);
// Full hygiene reset: sampled stacks + the always-on per-rank totals.
void nat_mu_prof_reset(void);
// Sampled stacks only — the per-rank totals stay monotonic (they are
// exported as Prometheus counters; debug pages use this one).
void nat_mu_prof_reset_samples(void);
int nat_mu_prof_report(int mode, char** out, size_t* out_len);
int nat_mu_rank_stats(brpc_tpu::NatLockRankRow* out, int max);
// Rank -> static name string (NULL when unnamed) — the tests' guard
// that the hand-mirrored name table tracks nat_lockrank.h.
const char* nat_mu_rank_name(int rank);
// Deterministic contention generator (tests/smokes): N threads fight
// over one declared-rank NatMutex; returns that rank's contended-wait
// count.
uint64_t nat_mu_contend_selftest(int nthreads, int iters, int hold_us);

// ---- refcount-contract runtime twin (nat_refguard.cpp) ----
// The NAT_REF_* ownership ledger of nat_refown.h, live only in
// -DNAT_REFGUARD builds (`make -C native refguard`); the exports exist
// in every build so the ABI surface is build-invariant.
// 1 when the ledger is compiled in.
int nat_refguard_enabled(void);
// Total ledger operations recorded (0 in normal builds).
uint64_t nat_refguard_ops(void);
// Scenario 0: balanced acquire/transfer/borrow/release/dead round,
// returns 0 in every build. Scenario 1: deliberate double release —
// refguard builds ABORT with the failing tag pair (the golden tests'
// seam); normal builds return -1.
int nat_refguard_selftest(int scenario);

// ---- traffic flight recorder (nat_dump.cpp / nat_replay.cpp) ----
// Capture: arm the always-on dump tap at the native protocol seams
// (tpu_std, native HTTP, gRPC/h2, redis store, kind-8 shm descriptors)
// — sample 1-in-`every` requests (seeded deterministic decimation) into
// per-thread lock-free rings drained by a background writer into
// recordio files under `dir` (butil/recordio.py-compatible), rotated
// past max_file_bytes keeping `generations` files. Payloads larger than
// max_payload are skipped whole (a truncated request is not
// replayable). 0 = ok, -1 = already running, -2 = dir/file error.
int nat_dump_start(const char* dir, int every, uint64_t seed,
                   uint64_t max_file_bytes, int generations,
                   uint64_t max_payload);
int nat_dump_stop(void);
int nat_dump_running(void);
int nat_dump_status(brpc_tpu::NatDumpStatusRec* out);
// Replay/press: re-fire captured recordio traffic (files = ';'-separated
// .rio paths / directories) through the native client lanes at a
// controlled rate — qps_from > 0 throttles (qps_to > 0 ramps linearly),
// qps_from <= 0 is press mode (no throttle, `concurrency` callers) —
// with latency quantiles recorded. 0 = ok, -1 = no replayable records,
// -2 = channel open failed.
int nat_replay_run(const char* ip, int port, const char* files, int times,
                   double qps_from, double qps_to, int concurrency,
                   int timeout_ms, brpc_tpu::NatReplayResult* out);

// ---- native memory observatory (nat_res.cpp, ISSUE 14) ----
// Always-on per-subsystem resource ledger (live bytes/objects,
// cumulative allocs/frees, high-water mark) recorded at every native
// allocator seam, plus a sampled allocation-site profiler behind
// /heap/native and /growth/native.
int nat_res_count(void);
const char* nat_res_name(int sub);
int nat_res_stats(brpc_tpu::NatResRow* out, int max);
uint64_t nat_res_accounted_bytes(void);
// Arm 1-in-`every` allocation-site stack sampling (seeded deterministic
// decimation; frees always recorded while armed). 0 ok, -1 running.
int nat_res_prof_start(int every, uint64_t seed);
int nat_res_prof_stop(void);
int nat_res_prof_running(void);
uint64_t nat_res_prof_samples(void);
void nat_res_prof_reset(void);
// Live bytes by allocation site: mode 0 = flat by leaf symbol, mode 1 =
// collapsed stacks weighted by live bytes. malloc'd (nat_buf_free).
int nat_res_heap_report(int mode, char** out, size_t* out_len);
// Re-take the growth zero point; the next growth report diffs against it.
int nat_res_growth_baseline(void);
// Collapsed stacks weighted by live-bytes GROWTH since the baseline.
int nat_res_growth_report(char** out, size_t* out_len);
// Deterministic alloc/free churn with a concurrent snapshot/report
// reader; 0 = the ledger balanced exactly (tests/smokes).
int nat_res_selftest(int nthreads, int iters);

// ---- in-process sampling profiler (nat_prof.cpp) ----
// SIGPROF/CPU-time stack sampling with frame-pointer unwind into
// lock-free per-thread rings; reports are flat symbol tables (mode 0)
// or collapsed stacks (mode 1), malloc'd (free with nat_buf_free).
int nat_prof_start(int hz);
int nat_prof_stop(void);
int nat_prof_running(void);
uint64_t nat_prof_samples(void);
void nat_prof_reset(void);
int nat_prof_report(int mode, char** out, size_t* out_len);

// ---- fuzz seams (nat_fuzz_entry.cpp / nat_replay.cpp) ----
// One entry per hand-rolled wire parser, each driving the REAL
// production path (messenger-style cut over a fake-socket fill, HPACK
// into a live dynamic table, recordio through the CRC/bounds loader,
// shm segment-image validation). Consumed by native/fuzz/ targets and
// replayed over the plain .so by tests/test_fuzz_regress.py. Returns
// 1 if the input parsed/was consumed, 0 if rejected — the interesting
// outcome is the sanitizer's, not the return value.
int nat_fuzz_rpc_meta(const char* data, size_t len);
int nat_fuzz_http(const char* data, size_t len);
int nat_fuzz_h2(const char* data, size_t len);
int nat_fuzz_redis(const char* data, size_t len);
int nat_fuzz_hpack(const char* data, size_t len);
int nat_fuzz_recordio(const char* data, size_t len);
int nat_fuzz_shm_seg(const char* data, size_t len);

}  // extern "C"
