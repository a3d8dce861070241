// Fuzz seams: one extern "C" entry per hand-rolled wire parser, each
// driving the REAL production path — not a reimplementation — so a
// fuzzer (native/fuzz/, libFuzzer or the bundled deterministic driver)
// and the regress replay test (tests/test_fuzz_regress.py, via ctypes)
// exercise exactly the code the runtime runs against hostile bytes.
//
// The protocol seams (http/h2/redis) run the messenger-style cut over a
// fake-socket fill: a heap NatSocket whose fd is /dev/null (writev of
// any control response succeeds, so no EAGAIN keep-write fiber and no
// set_failed teardown) owned by a handler-less NatServer with the py
// lane disabled — every request parses through the full session
// machinery and is answered by the native 404 / UNIMPLEMENTED /
// unknown-command arms, all deferred into a local batch IOBuf. The
// session object is freed after every input so each exec is
// reproducible standalone (a crash input replays without history).
//
// Return value is 0/1 (input rejected/consumed) purely for corpus
// statistics; the interesting outcome is the sanitizer's.

#include <fcntl.h>
#include <unistd.h>

#include "nat_internal.h"

namespace brpc_tpu {
namespace {

// One scheduler for the process: some write paths spawn a detached
// fiber (batch mode, EAGAIN requeue) and must find a live scheduler
// even though the fuzz inputs should never reach them.
void fuzz_runtime_init() {
  static bool once = [] {
    nat_sched_start(1);
    return true;
  }();
  (void)once;
}

struct FuzzConn {
  NatServer* srv = nullptr;
  NatSocket* sock = nullptr;

  explicit FuzzConn(int redis_mode) {
    srv = new NatServer();
    NAT_REF_ACQUIRED(srv, srv.fuzz);  // refs{1} = this FuzzConn
    srv->py_lane_enabled = false;  // native error arms answer everything
    srv->native_http = true;
    srv->native_redis = redis_mode;
    if (redis_mode != 0) srv->redis_store = redis_store_new();
    srv->freeze_handlers();  // empty maps: every lookup misses
    sock = new NatSocket();
    NAT_REF_ACQUIRED(sock, sock.fuzz);  // refs{1} = this FuzzConn
    sock->fd = open("/dev/null", O_WRONLY);
    sock->server = srv;
  }

  void feed(const char* data, size_t len) {
    sock->in_buf.clear();
    if (len != 0) sock->in_buf.append(data, len);
  }

  void reset_sessions() {
    if (sock->http != nullptr) {
      http_session_free(sock->http);
      sock->http = nullptr;
    }
    if (sock->h2 != nullptr) {
      h2_session_free(sock->h2);
      sock->h2 = nullptr;
    }
    if (sock->redis != nullptr) {
      redis_session_free(sock->redis);
      sock->redis = nullptr;
    }
    sock->in_buf.clear();
  }

  ~FuzzConn() {
    reset_sessions();
    if (sock->fd >= 0) ::close(sock->fd);
    sock->fd = -1;
    sock->server = nullptr;
    // NatSocket::release never frees (ResourcePool slot discipline:
    // the slot returns to sock_create's freelist) — this heap socket
    // was never registered anywhere, so retire it directly
    NAT_REF_RELEASED(sock, sock.fuzz);
    delete sock;
    NAT_REF_RELEASE(srv, srv.fuzz);
  }
};

}  // namespace
}  // namespace brpc_tpu

using namespace brpc_tpu;

extern "C" {

// tpu_std RpcMeta varint decode (rpc_meta.h) straight over the input.
int nat_fuzz_rpc_meta(const char* data, size_t len) {
  RpcMetaN meta;
  return decode_meta(data, len, &meta) ? 1 : 0;
}

// HTTP/1 server parse: sniff + header scan + body framing + the native
// 404 respond arm, through http_try_process's real session.
int nat_fuzz_http(const char* data, size_t len) {
  fuzz_runtime_init();
  FuzzConn c(0);
  c.feed(data, len);
  IOBuf batch;
  int rc = http_try_process(c.sock, &batch);
  return rc != 0 ? 1 : 0;
}

// h2 frame cut + HPACK into the session's real dynamic table + gRPC
// de-frame + UNIMPLEMENTED respond arm. The client preface is
// prepended so arbitrary inputs reach the frame loop instead of dying
// in the sniff.
int nat_fuzz_h2(const char* data, size_t len) {
  fuzz_runtime_init();
  static const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
  FuzzConn c(0);
  c.sock->in_buf.append(kPreface, sizeof(kPreface) - 1);
  if (len != 0) c.sock->in_buf.append(data, len);
  IOBuf batch;
  int rc = h2_try_process(c.sock, &batch);
  return rc != 0 ? 1 : 0;
}

// RESP command parse + the native store execute arm (no py lane).
int nat_fuzz_redis(const char* data, size_t len) {
  fuzz_runtime_init();
  FuzzConn c(2);
  c.feed(data, len);
  IOBuf batch;
  int rc = redis_try_process(c.sock, &batch);
  return rc != 0 ? 1 : 0;
}

// HPACK decode in isolation: a fresh decoder (static + dynamic table +
// huffman + size updates) over the raw block — narrower than nat_fuzz_h2
// so coverage isn't gated on valid frame framing.
int nat_fuzz_hpack(const char* data, size_t len) {
  void* dec = hpack_decoder_new();
  std::string flat, path;
  bool ok = hpack_decoder_decode(dec, (const uint8_t*)data, len, &flat,
                                 &path);
  hpack_decoder_free(dec);
  return ok ? 1 : 0;
}

// Forged shm segment image: the cross-process attach validation
// (magic/version/slots/arena vs claimed length) over arbitrary bytes.
int nat_fuzz_shm_seg(const char* data, size_t len) {
  return nat_shm_seg_validate(data, len);
}

}  // extern "C"
