// TCPStore: key-value rendezvous for multi-host bring-up.
//
// Native C++ equivalent of the reference's phi TCPStore
// (Paddle's paddle/phi/core/distributed/store/tcp_store.h:120,
// tcp_utils.cc): rank-0 hosts the store; clients SET/GET/ADD/WAIT keys to
// exchange bootstrap info (the reference broadcasts ncclUniqueId this way;
// here the launcher exchanges coordinator addresses and barrier counters
// before torch.distributed.init_process_group takes over).
//
// Protocol (length-prefixed, host byte order on one machine / launcher use):
//   u8 op | u32 klen | key | u32 vlen | value
//   ops: 0=SET 1=GET(blocking) 2=ADD(i64 delta -> i64 reply) 3=CHECK
//        4=DEL 5=LIST_KEYS
// Replies: u32 len | payload  (GET/ADD/CHECK/LIST); SET and DEL reply with
// an empty payload once applied, so a client's write is visible to every
// connection by the time the call returns (fire-and-forget writes let a
// CHECK on another connection overtake them).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Store {
  std::map<std::string, std::string> data;
  std::mutex mu;
  std::condition_variable cv;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> running{false};
  std::thread accept_thread;
  std::vector<std::thread> workers;
  std::mutex conn_mu;
  std::vector<int> conn_fds;
  Store store;
  ~Server() { stop(); }
  void stop() {
    if (running.exchange(false)) {
      shutdown(listen_fd, SHUT_RDWR);
      close(listen_fd);
      if (accept_thread.joinable()) accept_thread.join();
      {
        // wake serve_conn threads blocked in recv on live clients —
        // joining them without this deadlocks process exit whenever a
        // client (e.g. this process's own rendezvous connection) is
        // still connected
        std::lock_guard<std::mutex> g(conn_mu);
        for (int fd : conn_fds) shutdown(fd, SHUT_RDWR);
      }
      for (auto& w : workers)
        if (w.joinable()) w.join();
    }
  }
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_reply(int fd, const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  if (!write_full(fd, &len, 4)) return false;
  return payload.empty() || write_full(fd, payload.data(), payload.size());
}

void serve_conn(Server* srv, int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  while (srv->running) {
    uint8_t op;
    uint32_t klen, vlen;
    if (!read_full(fd, &op, 1) || !read_full(fd, &klen, 4)) break;
    std::string key(klen, '\0');
    if (klen && !read_full(fd, key.data(), klen)) break;
    if (!read_full(fd, &vlen, 4)) break;
    std::string val(vlen, '\0');
    if (vlen && !read_full(fd, val.data(), vlen)) break;

    Store& st = srv->store;
    if (op == 0) {  // SET
      {
        std::lock_guard<std::mutex> g(st.mu);
        st.data[key] = val;
      }
      st.cv.notify_all();
      if (!send_reply(fd, std::string())) break;
    } else if (op == 1) {  // blocking GET
      std::unique_lock<std::mutex> g(st.mu);
      st.cv.wait(g, [&] { return st.data.count(key) || !srv->running; });
      if (!srv->running) break;
      if (!send_reply(fd, st.data[key])) break;
    } else if (op == 2) {  // ADD
      int64_t delta = 0;
      memcpy(&delta, val.data(), std::min<size_t>(8, val.size()));
      int64_t now;
      {
        std::lock_guard<std::mutex> g(st.mu);
        int64_t cur = 0;
        auto it = st.data.find(key);
        if (it != st.data.end())
          memcpy(&cur, it->second.data(), std::min<size_t>(8, it->second.size()));
        now = cur + delta;
        st.data[key] = std::string(reinterpret_cast<char*>(&now), 8);
      }
      st.cv.notify_all();
      std::string reply(reinterpret_cast<char*>(&now), 8);
      if (!send_reply(fd, reply)) break;
    } else if (op == 3) {  // CHECK
      bool has;
      {
        std::lock_guard<std::mutex> g(st.mu);
        has = st.data.count(key) > 0;
      }
      std::string reply(1, has ? 1 : 0);
      if (!send_reply(fd, reply)) break;
    } else if (op == 4) {  // DEL
      {
        std::lock_guard<std::mutex> g(st.mu);
        st.data.erase(key);
      }
      st.cv.notify_all();
      if (!send_reply(fd, std::string())) break;
    } else if (op == 5) {  // LIST
      std::string keys;
      {
        std::lock_guard<std::mutex> g(st.mu);
        for (auto& kv : st.data) {
          keys += kv.first;
          keys += '\n';
        }
      }
      if (!send_reply(fd, keys)) break;
    } else {
      break;
    }
  }
  close(fd);
}

}  // namespace

extern "C" {

void* pt_store_server_start(int port) {
  auto* srv = new Server();
  srv->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      listen(srv->listen_fd, 128) != 0) {
    delete srv;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  srv->port = ntohs(addr.sin_port);
  srv->running = true;
  srv->accept_thread = std::thread([srv] {
    while (srv->running) {
      int fd = accept(srv->listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!srv->running) break;
        continue;
      }
      {
        std::lock_guard<std::mutex> g(srv->conn_mu);
        srv->conn_fds.push_back(fd);
      }
      srv->workers.emplace_back(serve_conn, srv, fd);
    }
  });
  return srv;
}

int pt_store_server_port(void* h) { return static_cast<Server*>(h)->port; }

void pt_store_server_stop(void* h) {
  auto* srv = static_cast<Server*>(h);
  srv->stop();
  delete srv;
}

struct Client {
  int fd = -1;
};

void* pt_store_client_connect(const char* host, int port, int timeout_ms) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (std::chrono::steady_clock::now() < deadline) {
    int fd = socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    inet_pton(AF_INET, host, &addr.sin_addr);
    if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new Client();
      c->fd = fd;
      return c;
    }
    close(fd);
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  return nullptr;
}

static bool send_cmd(Client* c, uint8_t op, const char* key, uint32_t klen,
                     const char* val, uint32_t vlen) {
  if (!write_full(c->fd, &op, 1)) return false;
  if (!write_full(c->fd, &klen, 4)) return false;
  if (klen && !write_full(c->fd, key, klen)) return false;
  if (!write_full(c->fd, &vlen, 4)) return false;
  if (vlen && !write_full(c->fd, val, vlen)) return false;
  return true;
}

// the empty reply of an acknowledged write (SET, DEL)
static int read_ack(Client* c) {
  uint32_t len;
  return read_full(c->fd, &len, 4) && len == 0 ? 0 : -1;
}

int pt_store_set(void* h, const char* key, const char* val, int vlen) {
  auto* c = static_cast<Client*>(h);
  if (!send_cmd(c, 0, key, static_cast<uint32_t>(strlen(key)), val,
                static_cast<uint32_t>(vlen)))
    return -1;
  return read_ack(c);
}

// blocking get; returns bytes written or -1; caller provides buffer
long pt_store_get(void* h, const char* key, char* out, long cap) {
  auto* c = static_cast<Client*>(h);
  if (!send_cmd(c, 1, key, static_cast<uint32_t>(strlen(key)), nullptr, 0))
    return -1;
  uint32_t len;
  if (!read_full(c->fd, &len, 4)) return -1;
  std::string tmp(len, '\0');
  if (len && !read_full(c->fd, tmp.data(), len)) return -1;
  long n = std::min<long>(cap, static_cast<long>(len));
  memcpy(out, tmp.data(), static_cast<size_t>(n));
  return static_cast<long>(len);
}

long long pt_store_add(void* h, const char* key, long long delta) {
  auto* c = static_cast<Client*>(h);
  if (!send_cmd(c, 2, key, static_cast<uint32_t>(strlen(key)),
                reinterpret_cast<char*>(&delta), 8))
    return -1;
  uint32_t len;
  if (!read_full(c->fd, &len, 4) || len != 8) return -1;
  long long out;
  if (!read_full(c->fd, &out, 8)) return -1;
  return out;
}

int pt_store_check(void* h, const char* key) {
  auto* c = static_cast<Client*>(h);
  if (!send_cmd(c, 3, key, static_cast<uint32_t>(strlen(key)), nullptr, 0))
    return -1;
  uint32_t len;
  if (!read_full(c->fd, &len, 4) || len != 1) return -1;
  char has;
  if (!read_full(c->fd, &has, 1)) return -1;
  return has;
}

int pt_store_del(void* h, const char* key) {
  auto* c = static_cast<Client*>(h);
  if (!send_cmd(c, 4, key, static_cast<uint32_t>(strlen(key)), nullptr, 0))
    return -1;
  return read_ack(c);
}

void pt_store_client_close(void* h) {
  auto* c = static_cast<Client*>(h);
  close(c->fd);
  delete c;
}

}  // extern "C"
