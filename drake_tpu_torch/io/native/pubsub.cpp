// Native pub/sub message transport — the LCM-role runtime component.
//
// Re-derivation of the reference's comms layer role (reference:
// lcm/drake_lcm.h — UDP-multicast pub/sub for robot/visualizer traffic,
// in-memory "memq://" for tests; SURVEY.md §2.7/§2.9).  This is NOT a
// compute fabric (XLA collectives own that); it is the host-side channel
// layer between simulator, controllers, loggers and visualizers.
//
// Two transports, selected by URL:
//   memq://<name>          in-process queues (deterministic, for tests)
//   udpm://<group>:<port>  UDP multicast, single-datagram messages
//
// Wire format (udpm): magic(4) | chan_len(u16 be) | channel | payload.
// C API surface (ctypes-friendly); thread-safe via a per-node mutex.

#include <algorithm>
#include <arpa/inet.h>
#include <cstring>
#include <cstdint>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <netinet/in.h>
#include <string>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x44545053;  // "DTPS"
constexpr int kMaxDatagram = 65000;

struct Message {
  std::string channel;
  std::vector<uint8_t> data;
};

struct Subscription {
  std::string channel;  // exact match or trailing '*' prefix wildcard
  std::deque<Message> queue;
};

bool ChannelMatches(const std::string& pattern, const std::string& channel) {
  if (!pattern.empty() && pattern.back() == '*') {
    return channel.compare(0, pattern.size() - 1,
                           pattern.substr(0, pattern.size() - 1)) == 0;
  }
  return pattern == channel;
}

struct Node;

// ---- memq registry: all nodes sharing a memq URL see each other. ----
struct MemqBus {
  std::mutex mu;
  std::vector<Node*> nodes;
};
std::mutex g_memq_mu;
std::map<std::string, std::shared_ptr<MemqBus>>& MemqBuses() {
  static auto* buses = new std::map<std::string, std::shared_ptr<MemqBus>>();
  return *buses;
}

struct Node {
  std::mutex mu;
  bool is_memq = false;
  std::shared_ptr<MemqBus> bus;  // memq
  int fd = -1;                   // udpm
  sockaddr_in dest {};
  std::vector<std::unique_ptr<Subscription>> subs;

  void Deliver(const Message& msg) {
    std::lock_guard<std::mutex> lock(mu);
    for (auto& sub : subs) {
      if (ChannelMatches(sub->channel, msg.channel)) {
        sub->queue.push_back(msg);
        if (sub->queue.size() > 1000) sub->queue.pop_front();  // bounded
      }
    }
  }
};

}  // namespace

extern "C" {

void* ps_create(const char* url_c) {
  std::string url(url_c);
  auto* node = new Node();
  if (url.rfind("memq://", 0) == 0) {
    node->is_memq = true;
    std::lock_guard<std::mutex> lock(g_memq_mu);
    auto& bus = MemqBuses()[url];
    if (!bus) bus = std::make_shared<MemqBus>();
    node->bus = bus;
    std::lock_guard<std::mutex> block(bus->mu);
    bus->nodes.push_back(node);
    return node;
  }
  if (url.rfind("udpm://", 0) == 0) {
    std::string rest = url.substr(7);
    auto colon = rest.find(':');
    std::string group = rest.substr(0, colon);
    int port = colon == std::string::npos ? 7667 : atoi(rest.c_str() + colon + 1);

    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) { delete node; return nullptr; }
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr {};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(port);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
      close(fd); delete node; return nullptr;
    }
    ip_mreq mreq {};
    mreq.imr_multiaddr.s_addr = inet_addr(group.c_str());
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));
    // Loopback so same-host processes hear each other.
    unsigned char loop = 1;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
    node->fd = fd;
    node->dest.sin_family = AF_INET;
    node->dest.sin_addr.s_addr = inet_addr(group.c_str());
    node->dest.sin_port = htons(port);
    return node;
  }
  delete node;
  return nullptr;
}

int ps_subscribe(void* handle, const char* channel) {
  auto* node = static_cast<Node*>(handle);
  std::lock_guard<std::mutex> lock(node->mu);
  auto sub = std::make_unique<Subscription>();
  sub->channel = channel;
  node->subs.push_back(std::move(sub));
  return static_cast<int>(node->subs.size()) - 1;
}

int ps_publish(void* handle, const char* channel, const uint8_t* data,
               int len) {
  auto* node = static_cast<Node*>(handle);
  if (node->is_memq) {
    Message msg{channel, std::vector<uint8_t>(data, data + len)};
    // Hold the bus mutex across delivery: a raw Node* snapshot would race
    // with ps_destroy on another thread (use-after-free).  Deliver only
    // takes the per-node mutex, so there is no lock-order cycle.
    std::lock_guard<std::mutex> lock(node->bus->mu);
    for (Node* n : node->bus->nodes) n->Deliver(msg);
    return 0;
  }
  size_t chan_len = strlen(channel);
  size_t total = 4 + 2 + chan_len + static_cast<size_t>(len);
  if (total > kMaxDatagram) return -1;
  std::vector<uint8_t> pkt(total);
  uint32_t magic = htonl(kMagic);
  memcpy(pkt.data(), &magic, 4);
  uint16_t cl = htons(static_cast<uint16_t>(chan_len));
  memcpy(pkt.data() + 4, &cl, 2);
  memcpy(pkt.data() + 6, channel, chan_len);
  memcpy(pkt.data() + 6 + chan_len, data, len);
  ssize_t sent = sendto(node->fd, pkt.data(), pkt.size(), 0,
                        (sockaddr*)&node->dest, sizeof(node->dest));
  return sent == static_cast<ssize_t>(pkt.size()) ? 0 : -1;
}

// Pump the network into subscriber queues; returns #messages processed.
int ps_handle_timeout(void* handle, int timeout_ms) {
  auto* node = static_cast<Node*>(handle);
  if (node->is_memq) return 0;  // memq delivers synchronously
  int count = 0;
  for (;;) {
    fd_set fds;
    FD_ZERO(&fds);
    FD_SET(node->fd, &fds);
    timeval tv {timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    int r = select(node->fd + 1, &fds, nullptr, nullptr, &tv);
    if (r <= 0) break;
    uint8_t buf[kMaxDatagram];
    ssize_t n = recv(node->fd, buf, sizeof(buf), 0);
    if (n < 6) continue;
    uint32_t magic;
    memcpy(&magic, buf, 4);
    if (ntohl(magic) != kMagic) continue;
    uint16_t cl;
    memcpy(&cl, buf + 4, 2);
    cl = ntohs(cl);
    if (6 + cl > n) continue;
    Message msg;
    msg.channel.assign(reinterpret_cast<char*>(buf) + 6, cl);
    msg.data.assign(buf + 6 + cl, buf + n);
    node->Deliver(msg);
    ++count;
    timeout_ms = 0;  // drain without further blocking
  }
  return count;
}

// Pop one message; returns payload length (>=0), -1 if empty, -2 small buf.
int ps_receive(void* handle, int sub_id, uint8_t* buf, int buf_len,
               char* chan_out, int chan_out_len) {
  auto* node = static_cast<Node*>(handle);
  std::lock_guard<std::mutex> lock(node->mu);
  if (sub_id < 0 || sub_id >= static_cast<int>(node->subs.size())) return -3;
  auto& q = node->subs[sub_id]->queue;
  if (q.empty()) return -1;
  Message& msg = q.front();
  if (static_cast<int>(msg.data.size()) > buf_len) return -2;
  memcpy(buf, msg.data.data(), msg.data.size());
  snprintf(chan_out, chan_out_len, "%s", msg.channel.c_str());
  int n = static_cast<int>(msg.data.size());
  q.pop_front();
  return n;
}

int ps_queue_size(void* handle, int sub_id) {
  auto* node = static_cast<Node*>(handle);
  std::lock_guard<std::mutex> lock(node->mu);
  if (sub_id < 0 || sub_id >= static_cast<int>(node->subs.size())) return -1;
  return static_cast<int>(node->subs[sub_id]->queue.size());
}

void ps_destroy(void* handle) {
  auto* node = static_cast<Node*>(handle);
  if (node->is_memq) {
    std::lock_guard<std::mutex> lock(node->bus->mu);
    auto& v = node->bus->nodes;
    v.erase(std::remove(v.begin(), v.end(), node), v.end());
  } else if (node->fd >= 0) {
    close(node->fd);
  }
  delete node;
}

}  // extern "C"
