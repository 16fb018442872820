// An own copy of native/frontend/h2_server.cc.
#include "h2_server.h"

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <cstring>

namespace ctpu {
namespace h2srv {

namespace {

constexpr uint8_t kFrameData = 0x0;
constexpr uint8_t kFrameHeaders = 0x1;
constexpr uint8_t kFramePriority = 0x2;
constexpr uint8_t kFrameRstStream = 0x3;
constexpr uint8_t kFrameSettings = 0x4;
constexpr uint8_t kFramePushPromise = 0x5;
constexpr uint8_t kFramePing = 0x6;
constexpr uint8_t kFrameGoaway = 0x7;
constexpr uint8_t kFrameWindowUpdate = 0x8;
constexpr uint8_t kFrameContinuation = 0x9;

constexpr uint8_t kFlagEndStream = 0x1;   // DATA, HEADERS
constexpr uint8_t kFlagAck = 0x1;         // SETTINGS, PING
constexpr uint8_t kFlagEndHeaders = 0x4;  // HEADERS, CONTINUATION
constexpr uint8_t kFlagPadded = 0x8;
constexpr uint8_t kFlagPriority = 0x20;

constexpr uint16_t kSettingsHeaderTableSize = 0x1;
constexpr uint16_t kSettingsMaxConcurrentStreams = 0x3;
constexpr uint16_t kSettingsInitialWindowSize = 0x4;
constexpr uint16_t kSettingsMaxFrameSize = 0x5;

// Advertised receive windows: large, replenished past a threshold, so bulk
// uploads (multi-MB inline tensors) stream without stalling on us.
constexpr int64_t kRecvWindow = 1 << 30;
constexpr int64_t kRecvUpdateThreshold = 1 << 20;
// Our SETTINGS_MAX_FRAME_SIZE: bigger inbound DATA frames = fewer
// header-parse iterations for bulk uploads.
constexpr uint32_t kOurMaxFrame = 1 << 20;
// Hard cap on any inbound frame (our max frame + generous slack).
constexpr size_t kMaxFramePayload = (1 << 20) + 16384;

const char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";

void PutU16(uint8_t* p, uint16_t v) {
  p[0] = v >> 8;
  p[1] = v & 0xff;
}

void PutU32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = (v >> 16) & 0xff;
  p[2] = (v >> 8) & 0xff;
  p[3] = v & 0xff;
}

uint32_t GetU32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void AppendFrame(std::string* out, uint8_t type, uint8_t flags,
                 uint32_t stream_id, const void* payload, size_t len) {
  uint8_t fh[9];
  PutU32(fh, static_cast<uint32_t>(len) << 8);
  fh[3] = type;
  fh[4] = flags;
  PutU32(fh + 5, stream_id);
  out->append(reinterpret_cast<char*>(fh), 9);
  if (len) out->append(static_cast<const char*>(payload), len);
}

}  // namespace

// -- ServerConnection --------------------------------------------------------

std::shared_ptr<ServerConnection> ServerConnection::Adopt(
    int fd, ConnectionCallbacks cbs) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::shared_ptr<ServerConnection> conn(new ServerConnection());
  conn->fd_ = fd;
  conn->cbs_ = std::move(cbs);
  return conn;
}

void ServerConnection::StartThreads() {
  reader_ = std::thread([this] {
    pthread_setname_np(pthread_self(), "ctpu-h2s-read");
    ReaderLoop();
  });
  writer_ = std::thread([this] {
    pthread_setname_np(pthread_self(), "ctpu-h2s-write");
    WriterLoop();
  });
}

ServerConnection::~ServerConnection() {
  Shutdown();
  Join();
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

void ServerConnection::Shutdown() {
  dead_.store(true);
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  {
    std::lock_guard<std::mutex> lk(mu_);
    writer_stop_ = true;
  }
  wq_cv_.notify_all();
}

void ServerConnection::Join() {
  if (reader_.joinable()) reader_.join();
  if (writer_.joinable()) writer_.join();
}

bool ServerConnection::ReadN(uint8_t* buf, size_t len) {
  // Buffered: a unary gRPC request is several SMALL frames and the frame
  // loop calls ReadN twice per frame (header, payload); one large recv
  // drains many frames per syscall under load. Reader-thread only.
  if (rbuf_.empty()) rbuf_.resize(64 * 1024);
  while (len > 0) {
    if (roff_ == rlen_) {
      ssize_t n = ::recv(fd_, rbuf_.data(), rbuf_.size(), 0);
      if (n < 0 && errno == EINTR) continue;
      if (n <= 0) return false;
      rlen_ = static_cast<size_t>(n);
      roff_ = 0;
    }
    const size_t take = std::min(len, rlen_ - roff_);
    memcpy(buf, rbuf_.data() + roff_, take);
    roff_ += take;
    buf += take;
    len -= take;
  }
  return true;
}

bool ServerConnection::WriteAll(const void* data, size_t len) {
  const char* p = static_cast<const char*>(data);
  while (len > 0) {
    ssize_t n = ::send(fd_, p, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    p += n;
    len -= n;
  }
  return true;
}

ServerConnection::StreamState* ServerConnection::GetStream(
    uint32_t stream_id) {
  auto it = streams_.find(stream_id);
  return it == streams_.end() ? nullptr : &it->second;
}

void ServerConnection::Fatal(uint32_t error_code, const std::string& reason) {
  (void)error_code;
  (void)reason;
  dead_.store(true);
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  {
    std::lock_guard<std::mutex> lk(mu_);
    writer_stop_ = true;
  }
  wq_cv_.notify_all();
}

void ServerConnection::ReaderLoop() {
  // Client preface, then our server preface (SETTINGS + window top-up).
  uint8_t preface[24];
  bool ok = ReadN(preface, sizeof(preface)) &&
            memcmp(preface, kPreface, 24) == 0;
  if (ok) {
    std::string out;
    uint8_t settings[12];
    PutU16(settings + 0, kSettingsInitialWindowSize);
    PutU32(settings + 2, static_cast<uint32_t>(kRecvWindow));
    PutU16(settings + 6, kSettingsMaxFrameSize);
    PutU32(settings + 8, kOurMaxFrame);
    AppendFrame(&out, kFrameSettings, 0, 0, settings, sizeof(settings));
    uint8_t wu[4];
    PutU32(wu, static_cast<uint32_t>(kRecvWindow - 65535));
    AppendFrame(&out, kFrameWindowUpdate, 0, 0, wu, 4);
    {
      std::lock_guard<std::mutex> lk(mu_);
      wq_.push_back(WriteItem{ItemKind::kRaw, 0, std::move(out), {}, false, 0});
    }
    wq_cv_.notify_all();
  }
  if (ok) {
    std::vector<uint8_t> payload;
    for (;;) {
      uint8_t fh[9];
      if (!ReadN(fh, 9)) break;
      size_t len = (size_t(fh[0]) << 16) | (size_t(fh[1]) << 8) | fh[2];
      uint8_t type = fh[3];
      uint8_t flags = fh[4];
      uint32_t stream_id = GetU32(fh + 5) & 0x7fffffff;
      if (len > kMaxFramePayload) break;
      payload.resize(len);
      if (len && !ReadN(payload.data(), len)) break;
      if (dead_.load()) break;
      HandleFrame(type, flags, stream_id, payload.data(), len);
      if (dead_.load()) break;
    }
  }
  dead_.store(true);
  // Half-close so the peer learns immediately — without this, a client
  // that spoke the wrong protocol (e.g. a TLS ClientHello against this
  // cleartext port) blocks forever waiting for bytes that never come.
  if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  {
    std::lock_guard<std::mutex> lk(mu_);
    writer_stop_ = true;
  }
  wq_cv_.notify_all();
  if (!close_fired_.exchange(true) && cbs_.on_close) cbs_.on_close(this);
}

void ServerConnection::HandleFrame(uint8_t type, uint8_t flags,
                                   uint32_t stream_id, const uint8_t* payload,
                                   size_t len) {
  if (in_header_block_ && type != kFrameContinuation) {
    Fatal(0x1, "expected CONTINUATION");
    return;
  }
  switch (type) {
    case kFrameData: {
      if (stream_id == 0) return Fatal(0x1, "DATA on stream 0");
      size_t consumed = len;
      const uint8_t* data = payload;
      if (flags & kFlagPadded) {
        if (len < 1) return Fatal(0x1, "bad padding");
        uint8_t pad = payload[0];
        if (size_t(pad) + 1 > len) return Fatal(0x1, "bad padding");
        data = payload + 1;
        len = len - 1 - pad;
      }
      bool end_stream = flags & kFlagEndStream;
      bool known;
      {
        std::lock_guard<std::mutex> lk(mu_);
        StreamState* st = GetStream(stream_id);
        known = st != nullptr;
        conn_recv_consumed_ += consumed;
        if (st != nullptr) {
          st->recv_consumed += consumed;
          if (end_stream) st->remote_done = true;
          if (st->reset) known = false;
        }
      }
      MaybeSendWindowUpdates(stream_id);
      if (!known) return;  // closed/reset stream: count for flow control only
      if (cbs_.on_data) cbs_.on_data(this, stream_id, data, len, end_stream);
      break;
    }
    case kFrameHeaders: {
      if (stream_id == 0) return Fatal(0x1, "HEADERS on stream 0");
      const uint8_t* block = payload;
      if (flags & kFlagPadded) {
        if (len < 1) return Fatal(0x1, "bad padding");
        uint8_t pad = payload[0];
        if (size_t(pad) + 1 > len) return Fatal(0x1, "bad padding");
        block = payload + 1;
        len = len - 1 - pad;
      }
      if (flags & kFlagPriority) {
        if (len < 5) return Fatal(0x1, "bad priority");
        block += 5;
        len -= 5;
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        if ((stream_id & 1) == 0 || stream_id <= max_seen_stream_) {
          // Even ids are server-initiated; a block on an old stream would be
          // client trailers, which gRPC clients never send.
          return Fatal(0x1, "bad client stream id");
        }
        max_seen_stream_ = stream_id;
        StreamState st;
        st.send_window = peer_initial_window_;
        if (flags & kFlagEndStream) st.remote_done = true;
        streams_.emplace(stream_id, st);
        header_block_.assign(reinterpret_cast<const char*>(block), len);
        header_block_stream_ = stream_id;
        header_block_end_stream_ = flags & kFlagEndStream;
        in_header_block_ = !(flags & kFlagEndHeaders);
      }
      if (flags & kFlagEndHeaders) {
        DispatchHeaderBlock(stream_id, flags & kFlagEndStream);
      }
      break;
    }
    case kFrameContinuation: {
      bool done;
      uint32_t sid;
      bool end_stream;
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (!in_header_block_ || stream_id != header_block_stream_) {
          return Fatal(0x1, "unexpected CONTINUATION");
        }
        header_block_.append(reinterpret_cast<const char*>(payload), len);
        if (header_block_.size() > (1u << 20)) {
          return Fatal(0xb, "header block too large");
        }
        done = flags & kFlagEndHeaders;
        if (done) in_header_block_ = false;
        sid = header_block_stream_;
        end_stream = header_block_end_stream_;
      }
      if (done) DispatchHeaderBlock(sid, end_stream);
      break;
    }
    case kFrameSettings: {
      if (flags & kFlagAck) return;
      if (len % 6 != 0) return Fatal(0x1, "bad SETTINGS");
      {
        std::lock_guard<std::mutex> lk(mu_);
        for (size_t i = 0; i + 6 <= len; i += 6) {
          uint16_t id = (uint16_t(payload[i]) << 8) | payload[i + 1];
          uint32_t value = GetU32(payload + i + 2);
          if (id == kSettingsInitialWindowSize) {
            int64_t delta =
                int64_t(value) - int64_t(peer_initial_window_);
            peer_initial_window_ = value;
            for (auto& kv : streams_) kv.second.send_window += delta;
          } else if (id == kSettingsMaxFrameSize) {
            if (value >= 16384 && value <= 16777215) peer_max_frame_ = value;
          } else if (id == kSettingsHeaderTableSize ||
                     id == kSettingsMaxConcurrentStreams) {
            // Our encoder never indexes (no dynamic table) and stream
            // concurrency is bounded by the inference core, not here.
          }
        }
      }
      std::string ack;
      AppendFrame(&ack, kFrameSettings, kFlagAck, 0, nullptr, 0);
      EnqueueRaw(std::move(ack));
      wq_cv_.notify_all();
      break;
    }
    case kFramePing: {
      if (flags & kFlagAck) return;
      if (len != 8) return Fatal(0x6, "bad PING");
      std::string pong;
      AppendFrame(&pong, kFramePing, kFlagAck, 0, payload, 8);
      EnqueueRaw(std::move(pong));
      wq_cv_.notify_all();
      break;
    }
    case kFrameWindowUpdate: {
      if (len != 4) return Fatal(0x1, "bad WINDOW_UPDATE");
      uint32_t inc = GetU32(payload) & 0x7fffffff;
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (stream_id == 0) {
          conn_send_window_ += inc;
        } else {
          StreamState* st = GetStream(stream_id);
          if (st != nullptr) st->send_window += inc;
        }
      }
      wq_cv_.notify_all();
      break;
    }
    case kFrameRstStream: {
      if (len != 4) return Fatal(0x1, "bad RST_STREAM");
      uint32_t code = GetU32(payload);
      bool known = false;
      {
        std::lock_guard<std::mutex> lk(mu_);
        StreamState* st = GetStream(stream_id);
        if (st != nullptr && !st->reset) {
          st->reset = true;
          known = true;
        }
      }
      if (known && cbs_.on_reset) cbs_.on_reset(this, stream_id, code);
      break;
    }
    case kFrameGoaway:
      // Peer will stop opening streams; serve what's in flight until the
      // socket closes.
      break;
    case kFramePriority:
      break;
    case kFramePushPromise:
      Fatal(0x1, "clients cannot push");
      break;
    default:
      break;  // unknown frame types are ignored per RFC 7540 §4.1
  }
}

void ServerConnection::DispatchHeaderBlock(uint32_t stream_id,
                                           bool end_stream) {
  std::vector<hpack::Header> headers;
  std::string err;
  bool ok;
  {
    std::lock_guard<std::mutex> lk(mu_);
    ok = decoder_.Decode(
        reinterpret_cast<const uint8_t*>(header_block_.data()),
        header_block_.size(), &headers, &err);
    header_block_.clear();
  }
  if (!ok) {
    Fatal(0x9, "HPACK error: " + err);
    return;
  }
  if (cbs_.on_headers) {
    cbs_.on_headers(this, stream_id, std::move(headers), end_stream);
  }
}

void ServerConnection::MaybeSendWindowUpdates(uint32_t stream_id) {
  std::string out;
  {
    std::lock_guard<std::mutex> lk(mu_);
    if (conn_recv_consumed_ >= kRecvUpdateThreshold) {
      uint8_t wu[4];
      PutU32(wu, static_cast<uint32_t>(conn_recv_consumed_));
      AppendFrame(&out, kFrameWindowUpdate, 0, 0, wu, 4);
      conn_recv_consumed_ = 0;
    }
    StreamState* st = GetStream(stream_id);
    if (st != nullptr && !st->remote_done &&
        st->recv_consumed >= kRecvUpdateThreshold) {
      uint8_t wu[4];
      PutU32(wu, static_cast<uint32_t>(st->recv_consumed));
      AppendFrame(&out, kFrameWindowUpdate, 0, stream_id, wu, 4);
      st->recv_consumed = 0;
    }
  }
  if (!out.empty()) {
    EnqueueRaw(std::move(out));
    wq_cv_.notify_all();
  }
}

void ServerConnection::EnqueueRawLocked(std::string frame) {
  // FIFO, not front-priority: the connection's FIRST frame must be our
  // SETTINGS (the server preface, RFC 7540 §3.5) — a SETTINGS ack jumping
  // the queue ahead of it is a protocol violation strict peers reject.
  wq_.push_back(WriteItem{ItemKind::kRaw, 0, std::move(frame), {}, false, 0});
}

void ServerConnection::EnqueueRaw(std::string frame) {
  std::lock_guard<std::mutex> lk(mu_);
  EnqueueRawLocked(std::move(frame));
}

// -- public send API ---------------------------------------------------------

void ServerConnection::SendHeaders(uint32_t stream_id,
                                   const std::vector<hpack::Header>& headers,
                                   bool end_stream) {
  if (dead_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    StreamState* st = GetStream(stream_id);
    if (st == nullptr || st->reset) return;
    WriteItem item{ItemKind::kHeaders, stream_id, {}, headers, end_stream, 0};
    wq_.push_back(std::move(item));
  }
  wq_cv_.notify_one();
}

void ServerConnection::SendData(uint32_t stream_id, std::string data,
                                bool end_stream) {
  if (dead_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    StreamState* st = GetStream(stream_id);
    if (st == nullptr || st->reset) return;
    WriteItem item{ItemKind::kData, stream_id, std::move(data), {},
                   end_stream, 0};
    wq_.push_back(std::move(item));
  }
  wq_cv_.notify_one();
}

void ServerConnection::SendTrailers(
    uint32_t stream_id, const std::vector<hpack::Header>& trailers) {
  if (dead_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    StreamState* st = GetStream(stream_id);
    if (st == nullptr || st->reset) return;
    WriteItem item{ItemKind::kTrailers, stream_id, {}, trailers, true, 0};
    wq_.push_back(std::move(item));
  }
  wq_cv_.notify_one();
}

void ServerConnection::SendResponse(
    uint32_t stream_id, const std::vector<hpack::Header>* headers,
    std::string* data, const std::vector<hpack::Header>* trailers) {
  if (dead_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    StreamState* st = GetStream(stream_id);
    if (st == nullptr || st->reset) return;
    if (headers != nullptr) {
      wq_.push_back(
          WriteItem{ItemKind::kHeaders, stream_id, {}, *headers, false, 0});
    }
    if (data != nullptr) {
      wq_.push_back(WriteItem{ItemKind::kData, stream_id, std::move(*data),
                              {}, false, 0});
    }
    if (trailers != nullptr) {
      wq_.push_back(
          WriteItem{ItemKind::kTrailers, stream_id, {}, *trailers, true, 0});
    }
  }
  wq_cv_.notify_one();
}

void ServerConnection::SendReset(uint32_t stream_id, uint32_t error_code) {
  if (dead_.load()) return;
  {
    std::lock_guard<std::mutex> lk(mu_);
    StreamState* st = GetStream(stream_id);
    if (st == nullptr || st->reset) return;
    st->reset = true;
    uint8_t payload[4];
    PutU32(payload, error_code);
    std::string frame;
    AppendFrame(&frame, kFrameRstStream, 0, stream_id, payload, 4);
    EnqueueRawLocked(std::move(frame));
  }
  wq_cv_.notify_all();
}

// -- writer ------------------------------------------------------------------

// Finds the index of the first writable queue item, dropping items for
// dead streams along the way. Streams whose head DATA is blocked on flow
// control are skipped entirely so a stalled stream never reorders its own
// frames or blocks other streams. Returns wq_.size() when nothing is
// writable. Caller holds mu_.
size_t ServerConnection::FindWritableLocked() {
  // Blocked-stream scratch: a small stack array covers the common case
  // (few flow-control-blocked streams) without the per-call allocation a
  // std::set would cost on this hot path; overflow spills to a set.
  uint32_t blocked_small[32];
  size_t n_blocked = 0;
  std::set<uint32_t> blocked_big;
  auto is_blocked = [&](uint32_t id) {
    for (size_t j = 0; j < n_blocked; ++j) {
      if (blocked_small[j] == id) return true;
    }
    return !blocked_big.empty() && blocked_big.count(id) > 0;
  };
  auto add_blocked = [&](uint32_t id) {
    if (n_blocked < 32) {
      blocked_small[n_blocked++] = id;
    } else {
      blocked_big.insert(id);
    }
  };
  for (size_t i = 0; i < wq_.size(); ++i) {
    WriteItem& it = wq_[i];
    if (it.kind != ItemKind::kRaw) {
      StreamState* st = GetStream(it.stream_id);
      if (st == nullptr || st->reset) {
        wq_.erase(wq_.begin() + i);
        --i;
        continue;
      }
      if (is_blocked(it.stream_id)) continue;
      if (it.kind == ItemKind::kData &&
          (st->send_window <= 0 || conn_send_window_ <= 0)) {
        add_blocked(it.stream_id);
        continue;
      }
    }
    return i;
  }
  return wq_.size();
}

// Encodes queue item `idx` (or the next window-limited chunk of it) onto
// `*out`, updating windows and stream state. Removes the item when fully
// consumed and returns true in that case. Caller holds mu_.
bool ServerConnection::EncodeItemLocked(size_t idx, std::string* out) {
  WriteItem& it = wq_[idx];
  bool remove = true;
  switch (it.kind) {
    case ItemKind::kRaw:
      out->append(it.payload);
      break;
    case ItemKind::kHeaders:
    case ItemKind::kTrailers: {
      std::string block;
      hpack::Encode(it.headers, &block);
      uint8_t flags = kFlagEndHeaders;
      bool end = it.end_stream || it.kind == ItemKind::kTrailers;
      if (end) flags |= kFlagEndStream;
      AppendFrame(out, kFrameHeaders, flags, it.stream_id, block.data(),
                  block.size());
      if (end) {
        StreamState* st = GetStream(it.stream_id);
        if (st != nullptr) {
          st->local_done = true;
          if (st->remote_done) streams_.erase(it.stream_id);
        }
      }
      break;
    }
    case ItemKind::kData: {
      StreamState* st = GetStream(it.stream_id);
      if (st == nullptr) break;
      size_t remaining = it.payload.size() - it.offset;
      size_t chunk = remaining;
      if (int64_t(chunk) > st->send_window) chunk = st->send_window;
      if (int64_t(chunk) > conn_send_window_) chunk = conn_send_window_;
      if (chunk > peer_max_frame_) chunk = peer_max_frame_;
      bool last = (chunk == remaining);
      uint8_t flags = (last && it.end_stream) ? kFlagEndStream : 0;
      AppendFrame(out, kFrameData, flags, it.stream_id,
                  it.payload.data() + it.offset, chunk);
      it.offset += chunk;
      st->send_window -= chunk;
      conn_send_window_ -= chunk;
      remove = last;
      if (last && it.end_stream) {
        st->local_done = true;
        if (st->remote_done) streams_.erase(it.stream_id);
      }
      break;
    }
  }
  if (remove) wq_.erase(wq_.begin() + idx);
  return remove;
}

void ServerConnection::WriterLoop() {
  // Batch every currently-writable frame into one send() — a unary gRPC
  // response is HEADERS+DATA+TRAILERS, so batching cuts syscalls ~3x and,
  // under concurrent streams, far more.
  constexpr size_t kBatchBytes = 256 * 1024;
  std::unique_lock<std::mutex> lk(mu_);
  for (;;) {
    size_t idx;
    while (!writer_stop_ && (idx = FindWritableLocked()) >= wq_.size()) {
      wq_cv_.wait(lk);
    }
    if (writer_stop_) return;
    std::string out;
    while (out.size() < kBatchBytes) {
      bool consumed = EncodeItemLocked(idx, &out);
      if (!consumed) break;  // window-limited partial DATA: flush now
      idx = FindWritableLocked();
      if (idx >= wq_.size()) break;
    }
    if (out.empty()) continue;
    lk.unlock();
    bool ok = WriteAll(out.data(), out.size());
    lk.lock();
    if (!ok) {
      dead_.store(true);
      writer_stop_ = true;
      if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
      return;
    }
  }
}

// -- Listener ----------------------------------------------------------------

std::unique_ptr<Listener> Listener::Start(const std::string& host, int port,
                                          ConnectionCallbacks cbs,
                                          std::string* err,
                                          const tls::ServerOptions* tls) {
  std::unique_ptr<tls::ServerContext> tls_ctx;
  if (tls != nullptr) {
    tls_ctx.reset(tls::ServerContext::Create(*tls, err));
    if (tls_ctx == nullptr) return nullptr;
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *err = "socket() failed";
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host.empty() || host == "0.0.0.0") {
    addr.sin_addr.s_addr = INADDR_ANY;
  } else if (inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
    *err = "bad listen address '" + host + "'";
    ::close(fd);
    return nullptr;
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    *err = "bind() failed for " + host + ":" + std::to_string(port);
    ::close(fd);
    return nullptr;
  }
  if (::listen(fd, 128) != 0) {
    *err = "listen() failed";
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);

  std::unique_ptr<Listener> l(new Listener());
  l->listen_fd_ = fd;
  l->port_ = ntohs(addr.sin_port);
  l->cbs_ = std::move(cbs);
  l->tls_ctx_ = std::move(tls_ctx);
  l->acceptor_ = std::thread([p = l.get()] {
    pthread_setname_np(pthread_self(), "ctpu-h2s-accept");
    p->AcceptLoop();
  });
  return l;
}

Listener::~Listener() { Stop(); }

void Listener::AcceptLoop() {
  for (;;) {
    int listen_fd = listen_fd_.load();
    if (listen_fd < 0) return;
    int fd = ::accept(listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (stopping_.load()) return;
      continue;
    }
    Reap(false);
    if (tls_ctx_ != nullptr) {
      // The TLS handshake runs off the accept loop: a slow (or malicious)
      // client must not stall other accepts. WrapAccepted runs it against
      // an absolute deadline, so a silent or trickling client cannot pin
      // the thread, nor hang Stop(), which drains in-flight handshakes.
      {
        std::lock_guard<std::mutex> lk(hs_mu_);
        hs_inflight_++;
      }
      std::thread([this, fd] {
        pthread_setname_np(pthread_self(), "ctpu-h2s-tls");
        std::string tls_err;
        int plain = tls_ctx_->WrapAccepted(fd, &tls_err);
        if (plain >= 0 && !stopping_.load()) {
          AdoptAccepted(plain);
        } else if (plain >= 0) {
          ::close(plain);
        }
        // a failed handshake drops the connection quietly (like an h2c RST)
        std::lock_guard<std::mutex> lk(hs_mu_);
        hs_inflight_--;
        hs_cv_.notify_all();
      }).detach();
      continue;
    }
    AdoptAccepted(fd);
  }
}

void Listener::AdoptAccepted(int fd) {
  auto conn = ServerConnection::Adopt(fd, cbs_);
  {
    std::lock_guard<std::mutex> lk(mu_);
    conns_.push_back(conn);
  }
  // Register with the receiver BEFORE frames can arrive, so the first
  // request on the connection cannot race the registration.
  if (cbs_.on_accept) cbs_.on_accept(conn);
  conn->StartThreads();
}

void Listener::Reap(bool all) {
  std::vector<std::shared_ptr<ServerConnection>> dead;
  {
    std::lock_guard<std::mutex> lk(mu_);
    for (size_t i = 0; i < conns_.size();) {
      if (all || !conns_[i]->alive()) {
        dead.push_back(std::move(conns_[i]));
        conns_.erase(conns_.begin() + i);
      } else {
        ++i;
      }
    }
  }
  for (auto& c : dead) {
    c->Shutdown();
    c->Join();
  }
}

void Listener::Stop() {
  if (stopping_.exchange(true)) return;
  // shutdown() unblocks accept(); the fd is closed only AFTER the acceptor
  // joins so a concurrently-accepted fd number can never be confused with
  // a recycled listener fd.
  int fd = listen_fd_.load();
  if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  if (acceptor_.joinable()) acceptor_.join();
  fd = listen_fd_.exchange(-1);
  if (fd >= 0) ::close(fd);
  {
    // Drain in-flight TLS handshakes (each bounded by its absolute
    // deadline) so no handshake thread touches a destroyed listener, and
    // any connection one adopted is reaped below.
    std::unique_lock<std::mutex> lk(hs_mu_);
    hs_cv_.wait(lk, [this] { return hs_inflight_ == 0; });
  }
  Reap(true);
}

}  // namespace h2srv
}  // namespace ctpu
