// Native TLS lane — SSL integrated into NatSocket itself, the reference's
// Socket-level SSLState design (socket.h:539-540, details/ssl_helper.cpp):
// the same port answers TLS and plaintext (sniffed from the first record
// byte), the handshake and record layer run as a memory-BIO filter inside
// the event loop, and every protocol lane (tpu_std, HTTP, h2, streaming,
// raw fallback) rides on the decrypted stream unchanged.
//
// The image ships libssl.so.3 without development headers, so the needed
// slice of the stable OpenSSL ABI is declared here and resolved with
// dlopen — the same functions every TLS-speaking program links.
#include <dlfcn.h>

#include "nat_internal.h"

namespace brpc_tpu {

// ---------------------------------------------------------------------------
// dlopen'd OpenSSL surface (stable exported symbols, OpenSSL 1.1+/3.x)
// ---------------------------------------------------------------------------

namespace ossl {
using SSL_CTX = void;
using SSL = void;
using BIO = void;
using SSL_METHOD = void;
using BIO_METHOD = void;

static const int kFiletypePem = 1;      // SSL_FILETYPE_PEM
static const int kErrorWantRead = 2;    // SSL_ERROR_WANT_READ
static const int kErrorWantWrite = 3;   // SSL_ERROR_WANT_WRITE
static const int kErrorZeroReturn = 6;  // SSL_ERROR_ZERO_RETURN

struct Lib {
  bool ok = false;
  int (*init_ssl)(uint64_t, const void*) = nullptr;
  const SSL_METHOD* (*tls_server_method)() = nullptr;
  SSL_CTX* (*ctx_new)(const SSL_METHOD*) = nullptr;
  int (*ctx_use_cert_chain)(SSL_CTX*, const char*) = nullptr;
  int (*ctx_use_privkey)(SSL_CTX*, const char*, int) = nullptr;
  SSL* (*ssl_new)(SSL_CTX*) = nullptr;
  void (*set_accept_state)(SSL*) = nullptr;
  const BIO_METHOD* (*bio_s_mem)() = nullptr;
  BIO* (*bio_new)(const BIO_METHOD*) = nullptr;
  void (*set_bio)(SSL*, BIO*, BIO*) = nullptr;
  int (*ssl_read)(SSL*, void*, int) = nullptr;
  int (*ssl_write)(SSL*, const void*, int) = nullptr;
  int (*get_error)(const SSL*, int) = nullptr;
  int (*bio_write)(BIO*, const void*, int) = nullptr;
  int (*bio_read)(BIO*, void*, int) = nullptr;
  size_t (*bio_ctrl_pending)(BIO*) = nullptr;
  void (*ssl_free)(SSL*) = nullptr;
  void (*ctx_set_alpn_select_cb)(
      SSL_CTX*,
      int (*)(SSL*, const unsigned char**, unsigned char*,
              const unsigned char*, unsigned int, void*),
      void*) = nullptr;
};

static Lib g_lib;
static std::once_flag g_lib_once;

template <typename T>
static bool sym(void* h, const char* name, T* out) {
  *out = (T)dlsym(h, name);
  return *out != nullptr;
}

static void lib_load() {
  void* h = nullptr;
  for (const char* name :
       {"libssl.so.3", "libssl.so.1.1", "libssl.so"}) {
    h = dlopen(name, RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr) break;
  }
  if (h == nullptr) return;
  Lib l;
  bool ok =
      sym(h, "OPENSSL_init_ssl", &l.init_ssl) &&
      sym(h, "TLS_server_method", &l.tls_server_method) &&
      sym(h, "SSL_CTX_new", &l.ctx_new) &&
      sym(h, "SSL_CTX_use_certificate_chain_file", &l.ctx_use_cert_chain) &&
      sym(h, "SSL_CTX_use_PrivateKey_file", &l.ctx_use_privkey) &&
      sym(h, "SSL_new", &l.ssl_new) &&
      sym(h, "SSL_set_accept_state", &l.set_accept_state) &&
      sym(h, "BIO_s_mem", &l.bio_s_mem) &&
      sym(h, "BIO_new", &l.bio_new) &&
      sym(h, "SSL_set_bio", &l.set_bio) &&
      sym(h, "SSL_read", &l.ssl_read) &&
      sym(h, "SSL_write", &l.ssl_write) &&
      sym(h, "SSL_get_error", &l.get_error) &&
      sym(h, "BIO_write", &l.bio_write) &&
      sym(h, "BIO_read", &l.bio_read) &&
      sym(h, "BIO_ctrl_pending", &l.bio_ctrl_pending) &&
      sym(h, "SSL_free", &l.ssl_free);
  // optional (present since 1.0.2); h2 clients need ALPN
  sym(h, "SSL_CTX_set_alpn_select_cb", &l.ctx_set_alpn_select_cb);
  if (!ok) return;
  l.init_ssl(0, nullptr);
  l.ok = true;
  g_lib = l;
}

static Lib& lib() {
  std::call_once(g_lib_once, lib_load);
  return g_lib;
}
}  // namespace ossl

// ---------------------------------------------------------------------------
// per-connection TLS session
// ---------------------------------------------------------------------------

struct SslSessionN {
  NatMutex<kLockRankSslSess> ssl_mu;  // feed (reading thread) vs SSL_write (any responder)
  ossl::SSL* ssl = nullptr;
  ossl::BIO* rbio = nullptr;  // ciphertext in (we write, SSL reads)
  ossl::BIO* wbio = nullptr;  // ciphertext out (SSL writes, we drain)
  bool failed = false;
  // plaintext written before the handshake finished (rare server-side);
  // flushed by the next feed that completes the handshake
  IOBuf pending_plain;

  ~SslSessionN() {
    if (ssl != nullptr) ossl::lib().ssl_free(ssl);  // frees both BIOs
  }
};

void ssl_session_free(SslSessionN* s) { delete s; }

// Requires sess->ssl_mu. Drains handshake/record output into *out.
static void ssl_drain_wbio_locked(SslSessionN* sess, IOBuf* out) {
  ossl::Lib& l = ossl::lib();
  char buf[16384];
  while (l.bio_ctrl_pending(sess->wbio) > 0) {
    int n = l.bio_read(sess->wbio, buf, sizeof(buf));
    if (n <= 0) break;
    out->append(buf, (size_t)n);
  }
}

// Requires sess->ssl_mu. Encrypts `plain` (fully — memory BIOs always accept)
// into *cipher_out. Returns false on TLS failure.
static bool ssl_encrypt_locked(NatSocket* s, SslSessionN* sess,
                               IOBuf&& plain, IOBuf* cipher_out) {
  ossl::Lib& l = ossl::lib();
  char tmp[16384];
  while (!plain.empty()) {
    size_t n = plain.length() < sizeof(tmp) ? plain.length() : sizeof(tmp);
    const char* p = plain.fetch(tmp, n);
    int w = l.ssl_write(sess->ssl, p, (int)n);
    if (w <= 0) {
      int err = l.get_error(sess->ssl, w);
      if (err == ossl::kErrorWantRead || err == ossl::kErrorWantWrite) {
        // handshake not finished: park the remainder; the feed path
        // flushes it once SSL_read completes the handshake
        sess->pending_plain.append(std::move(plain));
        ssl_drain_wbio_locked(sess, cipher_out);
        return true;
      }
      sess->failed = true;
      return false;
    }
    plain.pop_front((size_t)w);
  }
  ssl_drain_wbio_locked(sess, cipher_out);
  return true;
}

// Feed `n` ciphertext bytes; decrypted plaintext appends to s->in_buf and
// any TLS output (handshake records, parked responses) queues on the
// socket. Returns false on fatal TLS error (caller fails the socket).
bool ssl_feed(NatSocket* s, const char* data, size_t n) {
  SslSessionN* sess = s->ssl_sess;
  ossl::Lib& l = ossl::lib();
  IOBuf out;
  {
    std::lock_guard g(sess->ssl_mu);
    if (sess->failed) return false;
    size_t off = 0;
    while (off < n) {
      int w = l.bio_write(sess->rbio, data + off, (int)(n - off));
      if (w <= 0) {
        sess->failed = true;
        return false;
      }
      off += (size_t)w;
    }
    char buf[16384];
    while (true) {
      int r = l.ssl_read(sess->ssl, buf, sizeof(buf));
      if (r > 0) {
        s->in_buf.append(buf, (size_t)r);
        continue;
      }
      int err = l.get_error(sess->ssl, r);
      if (err == ossl::kErrorWantRead || err == ossl::kErrorWantWrite) {
        break;  // need more records (or to flush ours)
      }
      if (err == ossl::kErrorZeroReturn) {
        break;  // close_notify; EOF follows on the TCP level
      }
      sess->failed = true;
      return false;
    }
    ssl_drain_wbio_locked(sess, &out);
    if (!sess->pending_plain.empty()) {
      // the handshake may have just finished: flush parked plaintext
      IOBuf plain;
      plain.append(std::move(sess->pending_plain));
      if (!ssl_encrypt_locked(s, sess, std::move(plain), &out)) {
        return false;
      }
    }
    // queue while still holding sess->ssl_mu: record order on the wire must
    // match production order even against concurrent encrypt_and_write
    // callers (the wait-free push keeps wire order == queue order)
    if (!out.empty()) s->write_raw(std::move(out));
  }
  return true;
}

// Public encrypt entry for the write path (takes the session lock).
bool ssl_encrypt(NatSocket* s, IOBuf&& plain, IOBuf* cipher_out) {
  SslSessionN* sess = s->ssl_sess;
  std::lock_guard g(sess->ssl_mu);
  if (sess->failed) return false;
  return ssl_encrypt_locked(s, sess, std::move(plain), cipher_out);
}

// Encrypt AND queue under ONE session lock: record order on the wire
// must match encryption order, and two concurrent writers that encrypt
// A-then-B but queue B-then-A would corrupt the record stream (the peer
// MACs records sequentially). The MPSC write push happens under ssl_mu,
// so wire order is fixed here; the drain itself is lock-free.
int ssl_encrypt_and_write(NatSocket* s, IOBuf&& plain) {
  SslSessionN* sess = s->ssl_sess;
  std::lock_guard g(sess->ssl_mu);
  if (sess->failed) return -1;
  IOBuf cipher;
  if (!ssl_encrypt_locked(s, sess, std::move(plain), &cipher)) return -1;
  if (cipher.empty()) return 0;  // parked pre-handshake
  return s->write_raw(std::move(cipher));
}

// Sniffed a TLS record on a TLS-enabled server port: build the session.
bool ssl_accept_begin(NatSocket* s) {
  ossl::Lib& l = ossl::lib();
  if (!l.ok || s->server == nullptr || s->server->ssl_ctx == nullptr) {
    return false;
  }
  SslSessionN* sess = new SslSessionN();
  sess->ssl = l.ssl_new((ossl::SSL_CTX*)s->server->ssl_ctx);
  if (sess->ssl == nullptr) {
    delete sess;
    return false;
  }
  sess->rbio = l.bio_new(l.bio_s_mem());
  sess->wbio = l.bio_new(l.bio_s_mem());
  l.set_bio(sess->ssl, sess->rbio, sess->wbio);  // SSL owns the BIOs
  l.set_accept_state(sess->ssl);
  s->ssl_sess = sess;
  return true;
}

// ALPN selection (the next_protos of ServerSSLOptions): prefer h2 when
// the client offers it (gRPC requires the negotiation), else http/1.1,
// else accept without ALPN.
static int alpn_select(ossl::SSL*, const unsigned char** out,
                       unsigned char* outlen, const unsigned char* in,
                       unsigned int inlen, void*) {
  static const unsigned char kH2[] = "h2";
  static const unsigned char kH11[] = "http/1.1";
  for (const unsigned char* want : {kH2, kH11}) {
    size_t wl = strlen((const char*)want);
    unsigned int i = 0;
    while (i < inlen) {
      unsigned int plen = in[i];
      if (i + 1 + plen > inlen) break;
      if (plen == wl && memcmp(in + i + 1, want, wl) == 0) {
        *out = in + i + 1;
        *outlen = (unsigned char)plen;
        return 0;  // SSL_TLSEXT_ERR_OK
      }
      i += 1 + plen;
    }
  }
  return 3;  // SSL_TLSEXT_ERR_NOACK: proceed without ALPN
}

extern "C" {

// Configure TLS on the running native server (ServerSSLOptions role):
// PEM cert chain + private key. Returns 0, -1 when no server is running
// or the files are unusable, -2 when libssl is unavailable.
int nat_rpc_server_ssl(const char* cert_path, const char* key_path) {
  ossl::Lib& l = ossl::lib();
  if (!l.ok) return -2;
  std::lock_guard g(g_rt_mu);
  NatServer* srv = g_rpc_server;
  if (srv == nullptr) return -1;
  ossl::SSL_CTX* ctx = l.ctx_new(l.tls_server_method());
  if (ctx == nullptr) return -1;
  if (l.ctx_use_cert_chain(ctx, cert_path) != 1 ||
      l.ctx_use_privkey(ctx, key_path, ossl::kFiletypePem) != 1) {
    return -1;  // ctx intentionally not freed: no SSL_CTX_free needed
                // on this failure path more than once per process
  }
  if (l.ctx_set_alpn_select_cb != nullptr) {
    l.ctx_set_alpn_select_cb(ctx, alpn_select, nullptr);
  }
  srv->ssl_ctx = ctx;
  return 0;
}

}  // extern "C"

}  // namespace brpc_tpu
