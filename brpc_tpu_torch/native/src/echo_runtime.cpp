// Native echo runtime — the hot data path in C++, wire-compatible with the
// Python tpu_std protocol (tpu_std_protocol.py framing, itself the
// baidu_std analog: "TRPC" + body_size + meta_size + RpcMeta + payload).
//
// Server: one epoll loop (event_dispatcher_epoll.cpp:249 role), inline
// frame cut + echo response (the InputMessenger fast path without a user
// scheduler hop — echo's process cost target is the reference's 200-300ns
// class, docs/cn/benchmark.md:57).
// Client: N threads, each a connection running pipelined request windows
// (multi_threaded_echo_c++/client.cpp role).
#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "nat_api.h"
#include "rpc_meta.h"

namespace brpc_tpu {

static const char kMagic[4] = {'T', 'R', 'P', 'C'};

static uint32_t load_be32(const char* p) {
  return ((uint32_t)(uint8_t)p[0] << 24) | ((uint32_t)(uint8_t)p[1] << 16) |
         ((uint32_t)(uint8_t)p[2] << 8) | (uint32_t)(uint8_t)p[3];
}

static void store_be32(char* p, uint32_t v) {
  p[0] = (char)(v >> 24);
  p[1] = (char)(v >> 16);
  p[2] = (char)(v >> 8);
  p[3] = (char)v;
}

// Build one response frame: echo payload and attachment back under the
// same cid (attachment declared via meta.attachment_size, exactly as the
// Python pack_frame does).
static void build_response(std::string& out, int64_t cid, const char* payload,
                           size_t payload_len, const char* attachment,
                           size_t attachment_len) {
  RpcMetaN meta;
  meta.correlation_id = cid;
  meta.attachment_size = (int64_t)attachment_len;
  std::string mb = encode_response_meta(meta);
  size_t body = mb.size() + payload_len + attachment_len;
  size_t old = out.size();
  out.resize(old + 12);
  memcpy(&out[old], kMagic, 4);
  store_be32(&out[old + 4], (uint32_t)body);
  store_be32(&out[old + 8], (uint32_t)mb.size());
  out += mb;
  out.append(payload, payload_len);
  if (attachment_len) out.append(attachment, attachment_len);
}

struct Conn {
  int fd;
  std::string in;
  std::string out;
  size_t out_off = 0;
};

struct EchoServer {
  int listen_fd = -1;
  int port = 0;
  int epfd = -1;
  std::thread thread;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> requests{0};
  std::unordered_map<int, Conn*> conns;

  void run();
  void handle_readable(Conn* c);
  void flush(Conn* c);
};

static EchoServer* g_server = nullptr;

void EchoServer::flush(Conn* c) {
  while (c->out_off < c->out.size()) {
    ssize_t n = ::write(c->fd, c->out.data() + c->out_off,
                        c->out.size() - c->out_off);
    if (n > 0) {
      c->out_off += (size_t)n;
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      // register EPOLLOUT
      struct epoll_event ev;
      ev.events = EPOLLIN | EPOLLOUT;
      ev.data.fd = c->fd;
      epoll_ctl(epfd, EPOLL_CTL_MOD, c->fd, &ev);
      return;
    } else {
      return;  // broken; cleaned up on read error
    }
  }
  if (c->out_off == c->out.size() && c->out_off > 0) {
    c->out.clear();
    c->out_off = 0;
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.fd = c->fd;
    epoll_ctl(epfd, EPOLL_CTL_MOD, c->fd, &ev);
  }
}

void EchoServer::handle_readable(Conn* c) {
  char buf[65536];
  while (true) {
    ssize_t n = ::read(c->fd, buf, sizeof(buf));
    if (n > 0) {
      c->in.append(buf, (size_t)n);
      if ((size_t)n < sizeof(buf)) break;
    } else if (n == 0 || (errno != EAGAIN && errno != EWOULDBLOCK)) {
      epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
      ::close(c->fd);
      conns.erase(c->fd);
      delete c;
      return;
    } else {
      break;
    }
  }
  // cut frames
  size_t pos = 0;
  while (c->in.size() - pos >= 12) {
    const char* p = c->in.data() + pos;
    if (memcmp(p, kMagic, 4) != 0) {  // protocol error: drop connection
      epoll_ctl(epfd, EPOLL_CTL_DEL, c->fd, nullptr);
      ::close(c->fd);
      conns.erase(c->fd);
      delete c;
      return;
    }
    uint32_t body = load_be32(p + 4);
    uint32_t meta_size = load_be32(p + 8);
    if (c->in.size() - pos < 12 + body) break;
    RpcMetaN meta;
    if (decode_meta(p + 12, meta_size, &meta) && meta.has_request) {
      const char* payload = p + 12 + meta_size;
      size_t att = (size_t)meta.attachment_size;
      size_t payload_len = body - meta_size - att;
      build_response(c->out, meta.correlation_id, payload, payload_len,
                     payload + payload_len, att);
      requests.fetch_add(1, std::memory_order_relaxed);
    }
    pos += 12 + body;
  }
  if (pos > 0) c->in.erase(0, pos);
  if (!c->out.empty()) flush(c);
}

void EchoServer::run() {
  epfd = epoll_create1(0);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.fd = listen_fd;
  epoll_ctl(epfd, EPOLL_CTL_ADD, listen_fd, &ev);
  std::vector<struct epoll_event> events(256);
  while (!stop.load(std::memory_order_acquire)) {
    int n = epoll_wait(epfd, events.data(), (int)events.size(), 100);
    for (int i = 0; i < n; i++) {
      int fd = events[i].data.fd;
      if (fd == listen_fd) {
        while (true) {
          int cfd = accept4(listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          Conn* c = new Conn();
          c->fd = cfd;
          conns[cfd] = c;
          struct epoll_event cev;
          cev.events = EPOLLIN;
          cev.data.fd = cfd;
          epoll_ctl(epfd, EPOLL_CTL_ADD, cfd, &cev);
        }
        continue;
      }
      auto it = conns.find(fd);
      if (it == conns.end()) continue;
      Conn* c = it->second;
      if (events[i].events & EPOLLOUT) flush(c);
      if (events[i].events & EPOLLIN) handle_readable(c);
    }
  }
  for (auto& kv : conns) {
    ::close(kv.first);
    delete kv.second;
  }
  conns.clear();
  ::close(epfd);
  ::close(listen_fd);
}

extern "C" int nat_echo_server_start(const char* ip, int port) {
  if (g_server != nullptr) return -1;
  int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  inet_pton(AF_INET, ip, &addr.sin_addr);
  if (bind(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, (struct sockaddr*)&addr, &alen);
  if (listen(fd, 1024) != 0) {
    ::close(fd);
    return -1;
  }
  g_server = new EchoServer();
  g_server->listen_fd = fd;
  g_server->port = ntohs(addr.sin_port);
  g_server->thread = std::thread([] { g_server->run(); });
  return g_server->port;
}

extern "C" void nat_echo_server_stop() {
  if (g_server == nullptr) return;
  g_server->stop = true;
  if (g_server->thread.joinable()) g_server->thread.join();
  delete g_server;
  g_server = nullptr;
}

extern "C" uint64_t nat_echo_server_requests() {
  return g_server ? g_server->requests.load(std::memory_order_relaxed) : 0;
}

// ---- client bench ----

static std::string build_request(int64_t cid, const std::string& payload) {
  RpcMetaN meta;
  meta.has_request = true;
  meta.request.service_name = "EchoService";
  meta.request.method_name = "Echo";
  meta.correlation_id = cid;
  std::string mb = encode_request_meta(meta);
  std::string out;
  size_t body = mb.size() + payload.size();
  out.resize(12);
  memcpy(&out[0], kMagic, 4);
  store_be32(&out[4], (uint32_t)body);
  store_be32(&out[8], (uint32_t)mb.size());
  out += mb;
  out += payload;
  return out;
}

extern "C" double nat_echo_client_bench(const char* ip, int port, int nconn,
                                        double seconds, int payload_size,
                                        int pipeline, uint64_t* out_requests) {
  std::atomic<uint64_t> total{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> threads;
  std::string payload((size_t)payload_size, 'x');

  for (int t = 0; t < nconn; t++) {
    threads.emplace_back([&, t] {
      int fd = socket(AF_INET, SOCK_STREAM, 0);
      struct sockaddr_in addr;
      memset(&addr, 0, sizeof(addr));
      addr.sin_family = AF_INET;
      addr.sin_port = htons((uint16_t)port);
      inet_pton(AF_INET, ip, &addr.sin_addr);
      if (connect(fd, (struct sockaddr*)&addr, sizeof(addr)) != 0) {
        ::close(fd);
        return;
      }
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::string req = build_request(1000 + t, payload);
      std::string window;
      for (int k = 0; k < pipeline; k++) window += req;
      std::string inbuf;
      char rbuf[65536];
      while (!stop.load(std::memory_order_relaxed)) {
        // write the window
        size_t off = 0;
        while (off < window.size()) {
          ssize_t n = ::write(fd, window.data() + off, window.size() - off);
          if (n <= 0) goto done;
          off += (size_t)n;
        }
        // read pipeline responses
        int got = 0;
        while (got < pipeline) {
          ssize_t n = ::read(fd, rbuf, sizeof(rbuf));
          if (n <= 0) goto done;
          inbuf.append(rbuf, (size_t)n);
          size_t pos = 0;
          while (inbuf.size() - pos >= 12) {
            uint32_t body = load_be32(inbuf.data() + pos + 4);
            if (inbuf.size() - pos < 12 + body) break;
            pos += 12 + body;
            got++;
          }
          if (pos > 0) inbuf.erase(0, pos);
        }
        total.fetch_add((uint64_t)pipeline, std::memory_order_relaxed);
      }
    done:
      ::close(fd);
    });
  }
  auto t0 = std::chrono::steady_clock::now();
  std::this_thread::sleep_for(
      std::chrono::milliseconds((int64_t)(seconds * 1000)));
  stop = true;
  for (auto& th : threads) th.join();
  auto t1 = std::chrono::steady_clock::now();
  double dt = std::chrono::duration<double>(t1 - t0).count();
  if (out_requests) *out_requests = total.load(std::memory_order_relaxed);
  return dt > 0 ? (double)total.load(std::memory_order_relaxed) / dt : 0.0;
}

}  // namespace brpc_tpu
