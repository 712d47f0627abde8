#include "transport.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <cstdlib>
#include <cstring>
#include <thread>

namespace hvdtpu {

// ------------------------------------------------------------------ loopback
bool LoopbackHub::Gather(int rank, const std::string& mine,
                         std::vector<std::string>* all) {
  std::unique_lock<std::mutex> lk(mu_);
  uint64_t gen = gather_gen_;
  gathered_[rank] = mine;
  gather_count_++;
  if (gather_count_ == size_) {
    gather_count_ = 0;
    gather_gen_++;
    if (rank == 0 && all) *all = gathered_;
    cv_.notify_all();
    if (rank != 0) {
      // rank 0 may still be waiting; data already published.
    }
    if (rank == 0) return true;
  }
  if (rank == 0) {
    cv_.wait(lk, [&] { return gather_gen_ != gen; });
    if (all) *all = gathered_;
  } else if (gather_gen_ == gen) {
    cv_.wait(lk, [&] { return gather_gen_ != gen; });
  }
  return true;
}

bool LoopbackHub::Peek(int rank, uint64_t* kicks_seen) {
  std::lock_guard<std::mutex> lk(mu_);
  if (rank == 0) return gather_count_ > 0;
  if (kick_gen_ > *kicks_seen) {
    *kicks_seen = kick_gen_;
    return true;
  }
  return false;
}

void LoopbackHub::Kick() {
  std::lock_guard<std::mutex> lk(mu_);
  kick_gen_++;
  cv_.notify_all();
}

uint64_t LoopbackHub::kick_gen() {
  std::lock_guard<std::mutex> lk(mu_);
  return kick_gen_;
}

bool LoopbackHub::Bcast(int rank, std::string* frame,
                        uint64_t* consumed_rounds) {
  std::unique_lock<std::mutex> lk(mu_);
  if (rank == 0) {
    bcast_frame_ = *frame;
    bcast_reads_ = 0;
    bcast_gen_++;
    (*consumed_rounds)++;
    cv_.notify_all();
    // hold the round open until every worker has read it
    cv_.wait(lk, [&] { return bcast_reads_ == size_ - 1; });
  } else {
    // lock-step cycle protocol: this caller has consumed *consumed_rounds
    // rounds; wait for the next one (which may already be posted).
    cv_.wait(lk, [&] { return bcast_gen_ > *consumed_rounds; });
    *frame = bcast_frame_;
    (*consumed_rounds)++;
    bcast_reads_++;
    cv_.notify_all();
  }
  return true;
}

// ----------------------------------------------------------------------- env
namespace {

long EnvLong(const char* name, long def) {
  const char* v = getenv(name);
  if (!v || !*v) return def;
  return strtol(v, nullptr, 10);
}

double EnvDouble(const char* name, double def) {
  const char* v = getenv(name);
  if (!v || !*v) return def;
  return strtod(v, nullptr);
}

// Resolve a hostname or numeric address to an IPv4 sockaddr; false on
// failure (the launcher hands out hostnames, not just dotted quads).
bool ResolveIPv4(const std::string& host, uint16_t port, sockaddr_in* out) {
  memset(out, 0, sizeof(*out));
  out->sin_family = AF_INET;
  out->sin_port = htons(port);
  if (inet_pton(AF_INET, host.c_str(), &out->sin_addr) == 1) return true;
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  if (getaddrinfo(host.c_str(), nullptr, &hints, &res) != 0 || !res)
    return false;
  out->sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
  freeaddrinfo(res);
  return true;
}

void SetRecvTimeoutMs(int fd, long ms) {
  timeval tv{ms / 1000, static_cast<suseconds_t>((ms % 1000) * 1000)};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
}

void PutU64(std::string* s, uint64_t v) {
  char b[8];
  memcpy(b, &v, 8);
  s->append(b, 8);
}

uint64_t GetU64(const std::string& s, size_t off) {
  uint64_t v = 0;
  if (s.size() >= off + 8) memcpy(&v, s.data() + off, 8);
  return v;
}

// Frame wire format on the channel: [u64 seq][payload].
std::string SeqFrame(uint64_t seq, const std::string& payload) {
  std::string out;
  out.reserve(8 + payload.size());
  PutU64(&out, seq);
  out += payload;
  return out;
}

constexpr size_t kHelloSize = 20;  // u32 rank + u64 gathers + u64 bcasts

}  // namespace

// -------------------------------------------------------------------- chaos
ChaosInjector::ChaosInjector(int rank) {
  long target = EnvLong("HOROVOD_CHAOS_TCP_RANK", -1);
  close_after_ = EnvLong("HOROVOD_CHAOS_TCP_CLOSE_AFTER", 0);
  close_rate_ = EnvDouble("HOROVOD_CHAOS_TCP_CLOSE_RATE", 0.0);
  drop_rate_ = EnvDouble("HOROVOD_CHAOS_TCP_DROP_RATE", 0.0);
  dup_rate_ = EnvDouble("HOROVOD_CHAOS_TCP_DUP_RATE", 0.0);
  delay_rate_ = EnvDouble("HOROVOD_CHAOS_TCP_DELAY_RATE", 0.0);
  delay_ms_ = static_cast<int>(EnvLong("HOROVOD_CHAOS_TCP_DELAY_MS", 0));
  bool any = close_after_ > 0 || close_rate_ > 0 || drop_rate_ > 0 ||
             dup_rate_ > 0 || delay_rate_ > 0;
  bool targeted = target < 0 || target == rank;
  enabled_ = any && targeted;
  // Golden-ratio mix so every rank draws an independent stream from one
  // job-wide seed (same scheme the Python injector uses).
  uint64_t seed = static_cast<uint64_t>(EnvLong("HOROVOD_CHAOS_SEED", 0));
  rng_.seed(seed ^ (0x9E3779B97F4A7C15ull * (rank + 1)));
}

ChaosInjector::Action ChaosInjector::Next() {
  if (!enabled_) return Action::kNone;
  op_index_++;
  if (close_after_ > 0 &&
      op_index_ == static_cast<uint64_t>(close_after_))
    return Action::kClose;
  std::uniform_real_distribution<double> u(0.0, 1.0);
  double x = u(rng_);
  if (x < close_rate_) return Action::kClose;
  x -= close_rate_;
  if (x < drop_rate_) return Action::kDrop;
  x -= drop_rate_;
  if (x < dup_rate_) return Action::kDup;
  x -= dup_rate_;
  if (x < delay_rate_) return Action::kDelay;
  return Action::kNone;
}

// ----------------------------------------------------------------------- tcp
TcpTransport::TcpTransport(int rank, int size, const std::string& addr,
                           int port, int timeout_ms)
    : rank_(rank), size_(size), coord_addr_(addr), coord_port_(port),
      chaos_(rank) {
  max_retries_ =
      static_cast<int>(EnvLong("HOROVOD_CONTROLLER_RETRIES", 5));
  backoff_base_ms_ =
      static_cast<int>(EnvLong("HOROVOD_CONTROLLER_RETRY_BACKOFF_MS", 50));
  jitter_rng_.seed(
      static_cast<uint64_t>(EnvLong("HOROVOD_CHAOS_SEED", 1)) ^
      (0xD1B54A32D192ED03ull * (rank + 1)));
  if (size <= 1) { ok_ = true; return; }
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  if (rank == 0) {
    listen_fd_ = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_addr.s_addr = INADDR_ANY;
    sa.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) != 0)
      return;
    if (listen(listen_fd_, size) != 0) return;
    worker_fds_.assign(size, -1);
    gathers_from_.assign(size, 0);
    int connected = 0;
    while (connected < size - 1) {
      // bounded accept: a worker that never shows up must fail rank 0's
      // bring-up within timeout_ms, not hang init forever.
      auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
          deadline - std::chrono::steady_clock::now()).count();
      if (left <= 0) return;
      pollfd pfd{listen_fd_, POLLIN, 0};
      int pr = poll(&pfd, 1, static_cast<int>(left));
      if (pr <= 0) return;
      int fd = accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) return;
      int got = -1;
      if (!ResyncAccepted(fd, &got)) continue;  // stray: discarded inside
      if (worker_fds_[got] != -1) {  // duplicate hello for a live rank
        close(fd);
        continue;
      }
      worker_fds_[got] = fd;
      connected++;
    }
    ok_ = true;
  } else {
    if (WorkerHandshake()) { ok_ = true; return; }
    // Initial bring-up keeps the legacy behavior: retry plain connects
    // until the overall deadline, not just max_retries_ attempts.
    while (std::chrono::steady_clock::now() < deadline) {
      std::this_thread::sleep_for(std::chrono::milliseconds(100));
      if (WorkerHandshake()) { ok_ = true; return; }
    }
  }
}

TcpTransport::~TcpTransport() {
  if (listen_fd_ >= 0) close(listen_fd_);
  if (coord_fd_ >= 0) close(coord_fd_);
  for (int fd : worker_fds_)
    if (fd >= 0) close(fd);
}

bool TcpTransport::SendFramesV(int fd, const std::string* const* frames,
                               int n) {
  if (fd < 0 || n <= 0) return false;
  constexpr int kMax = 8;  // protocol sends at most a few frames per batch
  if (n > kMax) return false;
  uint32_t hdrs[kMax];
  iovec iov[2 * kMax];
  int iovcnt = 0;
  size_t total = 0;
  for (int i = 0; i < n; i++) {
    hdrs[i] = static_cast<uint32_t>(frames[i]->size());
    iov[iovcnt].iov_base = &hdrs[i];
    iov[iovcnt].iov_len = 4;
    iovcnt++;
    if (!frames[i]->empty()) {
      iov[iovcnt].iov_base = const_cast<char*>(frames[i]->data());
      iov[iovcnt].iov_len = frames[i]->size();
      iovcnt++;
    }
    total += 4 + frames[i]->size();
  }
  msghdr msg{};
  msg.msg_iov = iov;
  msg.msg_iovlen = iovcnt;
  int idx = 0;
  size_t sent_total = 0;
  while (sent_total < total) {
    ssize_t w = sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (w <= 0) return false;
    sent_total += static_cast<size_t>(w);
    // advance the iovec window past fully-written entries
    size_t left = static_cast<size_t>(w);
    while (left > 0 && idx < iovcnt) {
      if (left >= iov[idx].iov_len) {
        left -= iov[idx].iov_len;
        idx++;
      } else {
        iov[idx].iov_base = static_cast<char*>(iov[idx].iov_base) + left;
        iov[idx].iov_len -= left;
        left = 0;
      }
    }
    msg.msg_iov = iov + idx;
    msg.msg_iovlen = iovcnt - idx;
  }
  stats_.coalesced_bytes += total;
  if (n > 1) stats_.frames_coalesced += static_cast<uint64_t>(n);
  return true;
}

bool TcpTransport::SendFrame(int fd, const std::string& s) {
  const std::string* one[1] = {&s};
  return SendFramesV(fd, one, 1);
}

bool TcpTransport::RecvFrame(int fd, std::string* s) {
  if (fd < 0) return false;
  char hdr[4];
  size_t off = 0;
  while (off < 4) {
    ssize_t n = recv(fd, hdr + off, 4 - off, 0);
    if (n <= 0) return false;
    off += static_cast<size_t>(n);
  }
  uint32_t len;
  memcpy(&len, hdr, 4);
  if (len > (1u << 30)) return false;
  s->resize(len);
  off = 0;
  while (off < len) {
    ssize_t n = recv(fd, &(*s)[off], len - off, 0);
    if (n <= 0) return false;
    off += static_cast<size_t>(n);
  }
  return true;
}

// ---------------------------------------------------------------- resilience
bool TcpTransport::MaybeInject(int* fd, bool* dup) {
  *dup = false;
  if (!chaos_.enabled()) return true;
  switch (chaos_.Next()) {
    case ChaosInjector::Action::kNone:
      return true;
    case ChaosInjector::Action::kDelay:
      stats_.chaos_faults++;
      Trace('i', "chaos.delay", chaos_.delay_ms(), 'x');
      std::this_thread::sleep_for(
          std::chrono::milliseconds(chaos_.delay_ms()));
      return true;
    case ChaosInjector::Action::kDup:
      stats_.chaos_faults++;
      Trace('i', "chaos.dup", 0, 'x');
      *dup = true;
      return true;
    case ChaosInjector::Action::kClose:
      stats_.chaos_faults++;
      Trace('i', "chaos.close", 0, 'x');
      // shutdown (not close): the fd number stays valid, the next
      // send/recv on it fails into the recovery path on BOTH ends.
      if (*fd >= 0) ::shutdown(*fd, SHUT_RDWR);
      return true;
    case ChaosInjector::Action::kDrop:
      stats_.chaos_faults++;
      stats_.frames_dropped++;
      Trace('i', "chaos.drop", 0, 'x');
      // TCP cannot lose a frame on a live connection; an injected drop
      // therefore manifests as frame-never-sent + connection break, which
      // is exactly what the retransmission machinery must absorb.
      if (*fd >= 0) ::shutdown(*fd, SHUT_RDWR);
      return false;
  }
  return true;
}

int TcpTransport::ReacceptBudgetMs() const {
  // Cover the worker's full backoff schedule plus connect/handshake slack.
  long total = 0, step = backoff_base_ms_;
  for (int i = 0; i < max_retries_; i++) {
    total += step;
    step = std::min<long>(step * 2, 2000);
  }
  return static_cast<int>(total) + 3000;
}

bool TcpTransport::WorkerHandshake() {
  if (coord_fd_ >= 0) close(coord_fd_);
  coord_fd_ = -1;
  sockaddr_in sa{};
  if (!ResolveIPv4(coord_addr_, static_cast<uint16_t>(coord_port_), &sa))
    return false;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return false;
  if (connect(fd, reinterpret_cast<sockaddr*>(&sa), sizeof(sa)) != 0) {
    close(fd);
    return false;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // hello: rank + channel state, so rank 0 can resync this worker.
  std::string hello(4, '\0');
  memcpy(&hello[0], &rank_, 4);
  PutU64(&hello, gathers_sent_);
  PutU64(&hello, bcasts_seen_);
  if (!SendFrame(fd, hello)) {
    close(fd);
    return false;
  }
  // resync-ack: rank 0's count of gather frames it holds from us.  Bounded
  // read so a half-dead coordinator cannot hang the handshake.
  SetRecvTimeoutMs(fd, 5000);
  std::string ack;
  if (!RecvFrame(fd, &ack) || ack.size() != 8) {
    close(fd);
    return false;
  }
  SetRecvTimeoutMs(fd, 0);
  coord_fd_ = fd;
  uint64_t coord_has = GetU64(ack, 0);
  if (coord_has < gathers_sent_ && !last_gather_frame_.empty()) {
    // The break lost our in-flight gather frame; replay it (idempotent:
    // rank 0 dedups by seq).
    stats_.frames_resent++;
    Trace('i', "tcp.resend",
          static_cast<int64_t>(last_gather_frame_.size()));
    if (!SendFrame(coord_fd_, last_gather_frame_)) return false;
  }
  return true;
}

bool TcpTransport::WorkerReconnect() {
  Trace('B', "tcp.reconnect");
  long step = backoff_base_ms_;
  for (int attempt = 0; attempt < max_retries_; attempt++) {
    // full jitter: sleep U[step/2, step] so reconnect storms decorrelate
    std::uniform_int_distribution<long> u(step / 2, step);
    long sleep_ms = u(jitter_rng_);
    Trace('i', "tcp.backoff", sleep_ms);
    std::this_thread::sleep_for(std::chrono::milliseconds(sleep_ms));
    step = std::min<long>(step * 2, 2000);
    if (WorkerHandshake()) {
      stats_.reconnects++;
      Trace('E', "tcp.reconnect", attempt + 1);
      return true;
    }
  }
  stats_.reconnect_failures++;
  Trace('E', "tcp.reconnect", -1);
  return false;
}

bool TcpTransport::ResyncAccepted(int fd, int* got_rank) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // first frame from each worker is its hello; a stray connection (port
  // scanner, liveness probe, stale worker) is discarded rather than
  // failing bring-up.  Bound the read so a silent stray socket cannot
  // eat the budget.
  SetRecvTimeoutMs(fd, 2000);
  std::string hello;
  int r = -1;
  if (RecvFrame(fd, &hello) && hello.size() == kHelloSize)
    memcpy(&r, hello.data(), 4);
  if (r <= 0 || r >= size_) {
    close(fd);
    return false;
  }
  uint64_t peer_gathers = GetU64(hello, 4);
  uint64_t peer_bcasts = GetU64(hello, 12);
  // resync-ack: how many gather frames of theirs we hold — the worker
  // replays its pending frame iff we are behind.  When the worker also
  // missed the latest bcast round, the replay rides the SAME vectored
  // write as the ack (coalesced frame IO; lock-step bounds the gap to
  // one frame and the worker dedups by seq regardless).
  std::string ack;
  PutU64(&ack, gathers_from_[r]);
  bool replay = peer_bcasts < bcast_seq_ && !last_bcast_frame_.empty();
  const std::string* frames[2] = {&ack, &last_bcast_frame_};
  if (replay) {
    stats_.frames_resent++;
    Trace('i', "tcp.resend",
          static_cast<int64_t>(last_bcast_frame_.size()));
  }
  if (!SendFramesV(fd, frames, replay ? 2 : 1)) {
    close(fd);
    return false;
  }
  (void)peer_gathers;
  SetRecvTimeoutMs(fd, 0);
  *got_rank = r;
  return true;
}

bool TcpTransport::ReacceptWorker(int r) {
  Trace('B', "tcp.reaccept", r);
  if (worker_fds_[r] >= 0) close(worker_fds_[r]);
  worker_fds_[r] = -1;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(ReacceptBudgetMs());
  while (std::chrono::steady_clock::now() < deadline) {
    auto left = std::chrono::duration_cast<std::chrono::milliseconds>(
        deadline - std::chrono::steady_clock::now()).count();
    pollfd pfd{listen_fd_, POLLIN, 0};
    int pr = poll(&pfd, 1, static_cast<int>(std::max<long>(left, 1)));
    if (pr <= 0) break;
    int fd = accept(listen_fd_, nullptr, nullptr);
    if (fd < 0) continue;
    int got = -1;
    if (!ResyncAccepted(fd, &got)) continue;
    // Any reconnecting worker is resynced, not only the one we wait for —
    // two workers may fail in the same cycle.
    if (worker_fds_[got] >= 0) close(worker_fds_[got]);
    worker_fds_[got] = fd;
    stats_.reconnects++;
    if (got == r) {
      Trace('E', "tcp.reaccept", r);
      return true;
    }
  }
  stats_.reconnect_failures++;
  Trace('E', "tcp.reaccept", -1);
  return false;
}

// ------------------------------------------------------------- plan epochs
bool TcpTransport::Peek() {
  if (size_ == 1) return false;
  if (rank_ == 0) {
    for (int r = 1; r < size_; r++) {
      if (worker_fds_[r] < 0) continue;
      pollfd pfd{worker_fds_[r], POLLIN, 0};
      if (poll(&pfd, 1, 0) > 0) return true;
    }
    return false;
  }
  if (coord_fd_ < 0) return false;
  pollfd pfd{coord_fd_, POLLIN, 0};
  return poll(&pfd, 1, 0) > 0;
}

void TcpTransport::Kick() {
  // Rank 0 only: a zero-length advisory frame per worker.  Not
  // seq-tagged and not replayed — a kick lost to a connection break is
  // re-issued by the next break (the receiver treats any pending frame
  // as the wake signal anyway).  Best-effort: a dead fd fails into the
  // normal reaccept path on the next real frame op.
  if (rank_ != 0 || size_ == 1) return;
  static const std::string kEmpty;
  const std::string* one[1] = {&kEmpty};
  for (int r = 1; r < size_; r++)
    if (worker_fds_[r] >= 0) SendFramesV(worker_fds_[r], one, 1);
}

// -------------------------------------------------------------- collectives
bool TcpTransport::Gather(const std::string& mine,
                          std::vector<std::string>* all) {
  if (size_ == 1) {
    if (all) *all = {mine};
    return true;
  }
  if (rank_ == 0) {
    all->assign(size_, "");
    (*all)[0] = mine;
    for (int r = 1; r < size_; r++) {
      for (;;) {
        bool dup = false;
        MaybeInject(&worker_fds_[r], &dup);  // recv side: delay/close only
        std::string raw;
        if (!RecvFrame(worker_fds_[r], &raw)) {
          if (!ReacceptWorker(r)) return false;
          continue;
        }
        if (raw.size() < 8) return false;  // malformed: protocol error
        uint64_t seq = GetU64(raw, 0);
        if (seq <= gathers_from_[r]) continue;  // replayed dup: discard
        gathers_from_[r] = seq;
        Trace('i', "tcp.gather.recv", static_cast<int64_t>(raw.size()));
        (*all)[r] = raw.substr(8);
        break;
      }
    }
    return true;
  }
  // worker: seq-tag, remember for replay, send with reconnect-on-failure.
  last_gather_frame_ = SeqFrame(++gathers_sent_, mine);
  bool dup = false;
  bool send_it = MaybeInject(&coord_fd_, &dup);
  if (send_it && SendFrame(coord_fd_, last_gather_frame_)) {
    if (dup) SendFrame(coord_fd_, last_gather_frame_);  // rank 0 dedups
    Trace('i', "tcp.gather.send",
          static_cast<int64_t>(last_gather_frame_.size()));
    return true;
  }
  // Send failed (or the frame was chaos-dropped): the reconnect handshake
  // replays last_gather_frame_ iff rank 0 does not hold it.
  return WorkerReconnect();
}

bool TcpTransport::Bcast(std::string* frame) {
  if (size_ == 1) return true;
  if (rank_ == 0) {
    last_bcast_frame_ = SeqFrame(++bcast_seq_, *frame);
    for (int r = 1; r < size_; r++) {
      for (;;) {
        bool dup = false;
        bool send_it = MaybeInject(&worker_fds_[r], &dup);
        if (send_it && SendFrame(worker_fds_[r], last_bcast_frame_)) {
          if (dup)
            SendFrame(worker_fds_[r], last_bcast_frame_);  // worker dedups
          Trace('i', "tcp.bcast.send",
                static_cast<int64_t>(last_bcast_frame_.size()));
          break;
        }
        // ReacceptWorker's resync replays the frame when the worker
        // reports it missed this round; retry the plain send otherwise.
        if (!ReacceptWorker(r)) return false;
      }
    }
    return true;
  }
  for (;;) {
    bool dup = false;
    MaybeInject(&coord_fd_, &dup);  // recv side: delay/close only
    std::string raw;
    if (!RecvFrame(coord_fd_, &raw)) {
      if (!WorkerReconnect()) return false;
      continue;
    }
    if (raw.empty()) continue;  // rank-0 kick: advisory; real bcast follows
    if (raw.size() < 8) return false;
    uint64_t seq = GetU64(raw, 0);
    if (seq <= bcasts_seen_) continue;  // replayed dup: discard
    bcasts_seen_ = seq;
    Trace('i', "tcp.bcast.recv", static_cast<int64_t>(raw.size()));
    *frame = raw.substr(8);
    return true;
  }
}

}  // namespace hvdtpu
