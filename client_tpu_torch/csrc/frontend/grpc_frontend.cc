// Native gRPC front-end of the port: an h2c (or TLS, ALPN h2) gRPC server
// with a plain C ABI.
//
// The counterpart of native/frontend/grpc_frontend.cc without Python.h,
// numpy or libprotobuf. C++ threads own what they own there: the sockets,
// HTTP/2 and HPACK (h2_server, hpack), flow control, the gRPC
// length-prefixed framing, `grpc-timeout`, and the trailers with
// `grpc-status` and a percent-encoded `grpc-message`. Every whole request
// message goes up as bytes, tagged with its handle and method, through ONE
// event queue that the Python pump thread drains (ctpu_grpc_wait_events);
// cancels and expired deadlines travel through the same queue. Nothing here
// calls into Python, so no thread but the caller's ever needs the GIL.
// Python encodes each response message and hands it back with
// ctpu_grpc_complete (ModelInfer, ModelStreamInfer) or
// ctpu_grpc_complete_rpc (every other method), or with
// ctpu_grpc_complete_with_metadata when the trailers carry more than the
// status (a shedding router's `retry-after`).
//
// Every ModelStreamInfer stream gets a key of its own, carried by each of
// its request events, so a caller can treat the stream as one (a router
// pins it to one backend). Once the client can send no more requests on
// such a stream (it half-closed, reset the stream, dropped the connection,
// or its deadline passed) one stream-end event names the key; requests
// already delivered stay open until their final completion.
//
// Compressed request messages (grpc-encoding gzip / deflate) go up still
// compressed, flagged, and the bridge inflates them, so the build needs no
// zlib. Responses are never compressed.
//
// Locks: g_mu guards the pending-request and front-end registries; each
// front-end's `mu` its streams and connections, `q_mu` its event queue.
// Order: g_mu, then mu, then q_mu; never the reverse. ctypes releases the
// GIL around every call, so nothing relies on it.
//
// Event record, little-endian: u8 kind, u8 compression (0 identity,
// 1 gzip, 2 deflate), u64 handle, u64 stream key (0 outside
// ModelStreamInfer), u16 method length, u16 traceparent length, u64
// message length, then the method, the traceparent and the message bytes.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

#include "h2_server.h"

namespace ctpu {
namespace frontend {

namespace {

using Clock = std::chrono::steady_clock;

constexpr char kServicePrefix[] = "/inference.GRPCInferenceService/";

constexpr int kGrpcOk = 0;
constexpr int kGrpcDeadlineExceeded = 4;
constexpr int kGrpcUnimplemented = 12;
constexpr int kGrpcInternal = 13;

// Event kinds (client_tpu_torch/server/native_frontend.py reads them).
constexpr uint8_t kEventInfer = 0;        // a ModelInfer request
constexpr uint8_t kEventStreamInfer = 1;  // one request of a ModelStreamInfer
constexpr uint8_t kEventRpc = 2;          // any other method
constexpr uint8_t kEventCancel = 3;       // a delivered handle was cancelled
constexpr uint8_t kEventStreamEnd = 4;    // no more requests on a stream key

// What the pump's queue holds.
constexpr uint8_t kQueueDeliver = 0;    // a handle to deliver
constexpr uint8_t kQueueCancel = 1;     // a delivered handle's cancel
constexpr uint8_t kQueueStreamEnd = 2;  // a stream key's end

std::string PercentEncode(const std::string& in) {
  static const char* hex = "0123456789ABCDEF";
  std::string out;
  out.reserve(in.size());
  for (unsigned char c : in) {
    if (c >= 0x20 && c <= 0x7e && c != '%') {
      out.push_back(static_cast<char>(c));
    } else {
      out.push_back('%');
      out.push_back(hex[c >> 4]);
      out.push_back(hex[c & 0xf]);
    }
  }
  return out;
}

// 5-byte gRPC message framing.
std::string FrameMessage(const char* body, size_t len) {
  std::string out;
  out.reserve(len + 5);
  out.push_back('\0');
  out.push_back(static_cast<char>((len >> 24) & 0xff));
  out.push_back(static_cast<char>((len >> 16) & 0xff));
  out.push_back(static_cast<char>((len >> 8) & 0xff));
  out.push_back(static_cast<char>(len & 0xff));
  out.append(body, len);
  return out;
}

std::vector<hpack::Header> ResponseHeaders() {
  return {{":status", "200"},
          {"content-type", "application/grpc"},
          {"grpc-accept-encoding", "identity,gzip,deflate"}};
}

std::vector<hpack::Header> Trailers(int status, const std::string& message) {
  std::vector<hpack::Header> t{{"grpc-status", std::to_string(status)}};
  if (!message.empty()) t.push_back({"grpc-message", PercentEncode(message)});
  return t;
}

// `grpc-timeout`: 1-8 digits and a unit (H M S m u n). Returns false for a
// malformed value.
bool ParseTimeout(const std::string& v, Clock::duration* out) {
  if (v.size() < 2 || v.size() > 9) return false;
  uint64_t n = 0;
  for (size_t i = 0; i + 1 < v.size(); ++i) {
    if (v[i] < '0' || v[i] > '9') return false;
    n = n * 10 + static_cast<uint64_t>(v[i] - '0');
  }
  switch (v.back()) {
    case 'H': *out = std::chrono::hours(n); return true;
    case 'M': *out = std::chrono::minutes(n); return true;
    case 'S': *out = std::chrono::seconds(n); return true;
    case 'm': *out = std::chrono::milliseconds(n); return true;
    case 'u': *out = std::chrono::microseconds(n); return true;
    case 'n': *out = std::chrono::nanoseconds(n); return true;
    default: return false;
  }
}

struct Frontend;

// One request in flight to Python: queued until delivered, then kept until
// its final completion (or its cancel's).
struct Pending {
  Frontend* fe = nullptr;
  std::shared_ptr<h2srv::ServerConnection> conn;
  uint32_t stream_id = 0;
  uint8_t kind = kEventInfer;
  uint8_t compression = 0;
  uint64_t stream_key = 0;
  bool delivered = false;
  bool cancelled = false;
  std::string method;
  std::string traceparent;
  std::string message;  // moved out when delivered
};

// Per-h2-stream gRPC state.
struct GrpcStream {
  uint8_t kind = kEventRpc;
  std::string method;        // last :path segment
  std::string encoding;      // request grpc-encoding
  std::string traceparent;   // W3C trace context from the request headers
  std::string msg_buf;       // accumulating inbound gRPC frames
  bool headers_sent = false;
  bool end_stream_seen = false;
  uint64_t key = 0;          // ModelStreamInfer only: the stream's key
  bool end_reported = false; // its stream-end event is queued
  int pending = 0;           // dispatched, not yet final requests
  bool has_deadline = false;
  Clock::time_point deadline;
};

using StreamKey = std::pair<h2srv::ServerConnection*, uint32_t>;

struct Frontend {
  uint64_t id = 0;
  std::unique_ptr<h2srv::Listener> listener;
  std::atomic<bool> stopped{false};

  std::mutex mu;  // streams + conns
  std::map<h2srv::ServerConnection*, std::shared_ptr<h2srv::ServerConnection>>
      conns;
  // Streams still open on our side: an entry goes when its trailers are
  // queued or the peer resets it, so a late frame or completion finds
  // nothing and is dropped.
  std::map<StreamKey, GrpcStream> streams;

  std::mutex q_mu;
  std::condition_variable q_cv;
  std::deque<std::pair<uint8_t, uint64_t>> ready;  // (kQueue*, handle or key)
  bool q_stopped = false;
};

// The registries. Front-end structs live for the life of the process, so a
// completion that arrives after stop finds nothing and does nothing.
std::mutex g_mu;
std::map<uint64_t, Frontend*> g_frontends;
uint64_t g_next_frontend_id = 1;
std::map<uint64_t, std::unique_ptr<Pending>> g_pending;
uint64_t g_next_handle = 1;
std::atomic<uint64_t> g_next_stream_key{1};

void Enqueue(Frontend* fe, uint8_t what, uint64_t id) {
  {
    std::lock_guard<std::mutex> lk(fe->q_mu);
    fe->ready.emplace_back(what, id);
  }
  fe->q_cv.notify_one();
}

// The key of a ModelStreamInfer stream whose end is not yet reported, now
// marked reported; 0 otherwise. fe->mu held.
uint64_t TakeEnd(GrpcStream* gs) {
  if (gs->key == 0 || gs->end_reported) return 0;
  gs->end_reported = true;
  return gs->key;
}

void ReportEnd(Frontend* fe, uint64_t key) {
  if (key != 0) Enqueue(fe, kQueueStreamEnd, key);
}

void SendErrorTrailers(h2srv::ServerConnection* conn, uint32_t stream_id,
                       bool headers_sent, int status,
                       const std::string& message,
                       const std::vector<hpack::Header>& extra = {}) {
  auto trailers = Trailers(status, message);
  trailers.insert(trailers.end(), extra.begin(), extra.end());
  if (!headers_sent) {
    // trailers-only response
    auto headers = ResponseHeaders();
    headers.insert(headers.end(), trailers.begin(), trailers.end());
    conn->SendHeaders(stream_id, headers, true);
  } else {
    conn->SendTrailers(stream_id, trailers);
  }
}

// Fails a stream that is still open: closes it, then sends `status`.
void FailStream(Frontend* fe, h2srv::ServerConnection* conn,
                uint32_t stream_id, int status, const std::string& message) {
  bool headers_sent;
  uint64_t ended;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    auto it = fe->streams.find({conn, stream_id});
    if (it == fe->streams.end()) return;
    headers_sent = it->second.headers_sent;
    ended = TakeEnd(&it->second);
    fe->streams.erase(it);
  }
  SendErrorTrailers(conn, stream_id, headers_sent, status, message);
  ReportEnd(fe, ended);
}

// Splits whole gRPC messages off `buf`: (compressed flag, body) pairs. On
// malformed framing sets *bad and *bad_reason.
std::vector<std::pair<bool, std::string>> ExtractMessages(
    std::string* buf, const std::string& encoding, bool* bad,
    std::string* bad_reason) {
  std::vector<std::pair<bool, std::string>> out;
  size_t off = 0;
  while (buf->size() - off >= 5) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(buf->data()) + off;
    uint32_t len = (uint32_t(p[1]) << 24) | (uint32_t(p[2]) << 16) |
                   (uint32_t(p[3]) << 8) | uint32_t(p[4]);
    if (len > (1u << 30)) {
      *bad = true;
      *bad_reason = "gRPC message length exceeds 1 GiB";
      return out;
    }
    if (buf->size() - off - 5 < len) break;
    if (p[0] != 0 && encoding != "gzip" && encoding != "deflate") {
      *bad = true;
      *bad_reason = "unsupported message compression (grpc-encoding '" +
                    encoding + "')";
      return out;
    }
    out.emplace_back(p[0] != 0, std::string(buf->data() + off + 5, len));
    off += 5 + len;
  }
  buf->erase(0, off);
  return out;
}

// Registers one whole request message and queues it for the pump. The
// caller counted it in its stream's `pending` under the same lock that saw
// its bytes, so a completion racing this call cannot close the stream
// before the message is registered.
void Dispatch(Frontend* fe, h2srv::ServerConnection* conn, uint32_t stream_id,
              std::pair<bool, std::string> message) {
  auto pending = std::make_unique<Pending>();
  pending->fe = fe;
  pending->stream_id = stream_id;
  pending->message = std::move(message.second);
  uint64_t handle;
  {
    std::lock_guard<std::mutex> g(g_mu);
    {
      std::lock_guard<std::mutex> lk(fe->mu);
      auto cit = fe->conns.find(conn);
      auto sit = fe->streams.find({conn, stream_id});
      if (cit == fe->conns.end() || sit == fe->streams.end()) {
        return;  // torn down meanwhile: the peer is gone
      }
      const GrpcStream& gs = sit->second;
      pending->conn = cit->second;
      pending->kind = gs.kind;
      pending->stream_key = gs.key;
      pending->method = gs.method;
      pending->traceparent = gs.traceparent;
      if (message.first) pending->compression = gs.encoding == "gzip" ? 1 : 2;
    }
    handle = g_next_handle++;
    g_pending.emplace(handle, std::move(pending));
  }
  Enqueue(fe, kQueueDeliver, handle);
}

// Cancels the pending requests of one stream (or of every stream of
// `conn` when stream_id < 0): an undelivered one is dropped, a delivered
// one is marked and its cancel queued, so the bridge stops its work and
// completes it (a no-op on the wire).
void CancelPending(Frontend* fe, h2srv::ServerConnection* conn,
                   int64_t stream_id) {
  std::vector<uint64_t> cancels;
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (auto it = g_pending.begin(); it != g_pending.end();) {
      Pending* p = it->second.get();
      if (p->fe != fe || p->conn.get() != conn ||
          (stream_id >= 0 && p->stream_id != uint32_t(stream_id))) {
        ++it;
        continue;
      }
      if (!p->delivered) {
        it = g_pending.erase(it);
        continue;
      }
      if (!p->cancelled) {
        p->cancelled = true;
        cancels.push_back(it->first);
      }
      ++it;
    }
  }
  for (uint64_t h : cancels) Enqueue(fe, kQueueCancel, h);
}

// -- connection callbacks ----------------------------------------------------

void OnHeaders(Frontend* fe, h2srv::ServerConnection* conn,
               uint32_t stream_id, std::vector<hpack::Header> headers,
               bool end_stream) {
  std::string path;
  GrpcStream gs;
  for (const auto& h : headers) {
    if (h.name == ":path") {
      path = h.value;
    } else if (h.name == "grpc-encoding") {
      gs.encoding = h.value;
    } else if (h.name == "traceparent") {
      gs.traceparent = h.value;
    } else if (h.name == "grpc-timeout") {
      Clock::duration d;
      if (ParseTimeout(h.value, &d)) {
        gs.has_deadline = true;
        gs.deadline = Clock::now() + d;
      }
    }
  }
  bool known = path.rfind(kServicePrefix, 0) == 0;
  if (known) {
    gs.method = path.substr(sizeof(kServicePrefix) - 1);
    gs.kind = gs.method == "ModelInfer"         ? kEventInfer
              : gs.method == "ModelStreamInfer" ? kEventStreamInfer
                                                : kEventRpc;
  }
  gs.end_stream_seen = end_stream;
  if (known && !end_stream) {
    if (gs.kind == kEventStreamInfer) gs.key = g_next_stream_key++;
    std::lock_guard<std::mutex> lk(fe->mu);
    fe->streams[{conn, stream_id}] = std::move(gs);
    return;
  }
  if (!known) {
    SendErrorTrailers(conn, stream_id, false, kGrpcUnimplemented,
                      "unknown service in path '" + path + "'");
  } else if (end_stream) {
    // A request needs a body: an empty unary call is an error, an empty
    // stream completes cleanly.
    if (gs.kind == kEventStreamInfer) {
      conn->SendHeaders(stream_id, ResponseHeaders(), false);
      conn->SendTrailers(stream_id, Trailers(kGrpcOk, ""));
    } else {
      SendErrorTrailers(conn, stream_id, false, kGrpcInternal,
                        "request body missing");
    }
  }
}

void OnData(Frontend* fe, h2srv::ServerConnection* conn, uint32_t stream_id,
            const uint8_t* data, size_t len, bool end_stream) {
  std::vector<std::pair<bool, std::string>> messages;
  bool bad = false;
  std::string bad_reason = "malformed gRPC message framing";
  bool close_ok = false;  // an empty or fully answered stream half-closed
  bool headers_sent = false;
  uint64_t ended = 0;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    auto it = fe->streams.find({conn, stream_id});
    if (it == fe->streams.end()) return;
    GrpcStream& gs = it->second;
    gs.msg_buf.append(reinterpret_cast<const char*>(data), len);
    if (end_stream) gs.end_stream_seen = true;
    if (gs.kind == kEventStreamInfer) {
      messages = ExtractMessages(&gs.msg_buf, gs.encoding, &bad, &bad_reason);
      if (end_stream && !bad && gs.msg_buf.empty() && messages.empty() &&
          gs.pending == 0) {
        close_ok = true;
        headers_sent = gs.headers_sent;
      }
    } else if (end_stream) {
      // unary: one whole message once the client half-closes
      messages = ExtractMessages(&gs.msg_buf, gs.encoding, &bad, &bad_reason);
      if (!bad && (messages.size() != 1 || !gs.msg_buf.empty())) bad = true;
    }
    if (!bad) gs.pending += static_cast<int>(messages.size());
    if (bad || end_stream) ended = TakeEnd(&gs);
    if (bad || close_ok) fe->streams.erase(it);
  }
  if (bad) {
    SendErrorTrailers(conn, stream_id, false, kGrpcInternal, bad_reason);
    ReportEnd(fe, ended);
    return;
  }
  if (close_ok) {
    if (!headers_sent) conn->SendHeaders(stream_id, ResponseHeaders(), false);
    conn->SendTrailers(stream_id, Trailers(kGrpcOk, ""));
    ReportEnd(fe, ended);
    return;
  }
  for (auto& m : messages) Dispatch(fe, conn, stream_id, std::move(m));
  ReportEnd(fe, ended);  // after the stream's last requests
}

void OnReset(Frontend* fe, h2srv::ServerConnection* conn, uint32_t stream_id,
             uint32_t error_code) {
  (void)error_code;
  uint64_t ended = 0;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    auto it = fe->streams.find({conn, stream_id});
    if (it != fe->streams.end()) {
      ended = TakeEnd(&it->second);
      fe->streams.erase(it);
    }
  }
  CancelPending(fe, conn, stream_id);
  ReportEnd(fe, ended);
}

void OnClose(Frontend* fe, h2srv::ServerConnection* conn) {
  std::vector<uint64_t> ended;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    fe->conns.erase(conn);
    for (auto it = fe->streams.begin(); it != fe->streams.end();) {
      if (it->first.first == conn) {
        uint64_t key = TakeEnd(&it->second);
        if (key != 0) ended.push_back(key);
        it = fe->streams.erase(it);
      } else {
        ++it;
      }
    }
  }
  CancelPending(fe, conn, -1);
  for (uint64_t key : ended) ReportEnd(fe, key);
}

void OnAccept(Frontend* fe, std::shared_ptr<h2srv::ServerConnection> conn) {
  std::lock_guard<std::mutex> lk(fe->mu);
  fe->conns[conn.get()] = std::move(conn);
}

// Fails every stream whose grpc-timeout passed with DEADLINE_EXCEEDED and
// cancels its pending requests. Returns the nearest deadline still ahead
// (Clock::time_point::max() when there is none).
Clock::time_point ExpireDeadlines(Frontend* fe) {
  Clock::time_point now = Clock::now();
  Clock::time_point next = Clock::time_point::max();
  std::vector<StreamKey> expired;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    for (auto& kv : fe->streams) {
      GrpcStream& gs = kv.second;
      if (!gs.has_deadline) continue;
      if (gs.deadline <= now) {
        expired.push_back(kv.first);
      } else if (gs.deadline < next) {
        next = gs.deadline;
      }
    }
  }
  for (const StreamKey& key : expired) {
    FailStream(fe, key.first, key.second, kGrpcDeadlineExceeded,
               "Deadline Exceeded");
    CancelPending(fe, key.first, key.second);
  }
  return next;
}

void AppendU64(std::string* out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out->push_back(static_cast<char>(v >> (8 * i)));
}

void AppendU16(std::string* out, uint16_t v) {
  out->push_back(static_cast<char>(v & 0xff));
  out->push_back(static_cast<char>(v >> 8));
}

void AppendEvent(std::string* out, uint8_t kind, uint8_t compression,
                 uint64_t handle, uint64_t stream_key,
                 const std::string& method, const std::string& traceparent,
                 const std::string& message) {
  out->push_back(static_cast<char>(kind));
  out->push_back(static_cast<char>(compression));
  AppendU64(out, handle);
  AppendU64(out, stream_key);
  AppendU16(out, static_cast<uint16_t>(method.size()));
  AppendU16(out, static_cast<uint16_t>(traceparent.size()));
  AppendU64(out, message.size());
  out->append(method);
  out->append(traceparent);
  out->append(message);
}

Frontend* LookupFrontend(uint64_t id) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_frontends.find(id);
  return it == g_frontends.end() ? nullptr : it->second;
}

// One completion: `final` ends the handle (always, for unary and RPC
// handles). Unary: status 0 sends HEADERS + the framed body + OK trailers,
// another status a trailers-only (or trailers) error. Stream: the framed
// body goes out, and the stream closes with OK trailers once the client
// half-closed and no request is pending; a non-zero status fails the
// whole stream. `extra` trailers follow grpc-status and grpc-message.
int Complete(uint64_t handle, const char* body, uint64_t len, int status,
             const char* message, bool final_flag, bool rpc,
             const std::vector<hpack::Header>& extra = {}) {
  static const std::vector<hpack::Header>& kOkHeaders =
      *new std::vector<hpack::Header>(ResponseHeaders());
  static const std::vector<hpack::Header>& kOkTrailers =
      *new std::vector<hpack::Header>(Trailers(kGrpcOk, ""));
  std::unique_ptr<Pending> owned;  // freed at return on the final one
  Frontend* fe;
  std::shared_ptr<h2srv::ServerConnection> conn;
  uint32_t stream_id;
  bool streaming;
  {
    std::lock_guard<std::mutex> g(g_mu);
    auto it = g_pending.find(handle);
    if (it == g_pending.end()) return 0;  // finished, cancelled or stopped
    Pending* p = it->second.get();
    if (rpc != (p->kind == kEventRpc)) return -1;
    streaming = p->kind == kEventStreamInfer;
    if (!streaming) final_flag = true;
    fe = p->fe;
    conn = p->conn;
    stream_id = p->stream_id;
    bool cancelled = p->cancelled;
    if (final_flag) {
      owned = std::move(it->second);
      g_pending.erase(it);
    }
    if (cancelled) return 0;
  }
  if (!conn->alive()) return 0;
  std::string msg = message != nullptr ? message : "";
  bool headers_sent;
  bool close_stream;
  uint64_t ended = 0;
  {
    std::lock_guard<std::mutex> lk(fe->mu);
    auto it = fe->streams.find({conn.get(), stream_id});
    if (it == fe->streams.end()) return 0;
    GrpcStream& gs = it->second;
    if (final_flag) gs.pending--;
    headers_sent = gs.headers_sent;
    gs.headers_sent = true;
    close_stream = status != kGrpcOk || !streaming ||
                   (gs.end_stream_seen && gs.pending == 0);
    if (close_stream) {
      ended = TakeEnd(&gs);
      fe->streams.erase(it);
    }
  }
  ReportEnd(fe, ended);
  if (status != kGrpcOk) {
    SendErrorTrailers(conn.get(), stream_id, headers_sent, status, msg, extra);
    return 0;
  }
  std::string framed;
  std::string* data = nullptr;
  if (!streaming || len > 0) {
    framed = FrameMessage(body, static_cast<size_t>(len));
    data = &framed;
  }
  std::vector<hpack::Header> trailers;
  const std::vector<hpack::Header>* closing = nullptr;
  if (close_stream) {
    closing = &kOkTrailers;
    if (!extra.empty()) {
      trailers = kOkTrailers;
      trailers.insert(trailers.end(), extra.begin(), extra.end());
      closing = &trailers;
    }
  }
  conn->SendResponse(stream_id, headers_sent ? nullptr : &kOkHeaders, data,
                     closing);
  return 0;
}

}  // namespace
}  // namespace frontend
}  // namespace ctpu

using ctpu::frontend::Frontend;

extern "C" {

// Binds host:port (0 picks a free port) and serves. With a certificate
// chain and a key (PEM paths; both null or empty for h2c) the port speaks
// TLS with ALPN h2 instead, and a context that cannot be built (no
// libssl.so.3, an unreadable or mismatched PEM) fails the start. Returns
// the front-end's id, or 0 with the reason in err.
uint64_t ctpu_grpc_start(const char* host, int port, const char* tls_cert,
                         const char* tls_key, char* err, int err_len) {
  using namespace ctpu;
  using namespace ctpu::frontend;
  auto* fe = new Frontend();
  h2srv::ConnectionCallbacks cbs;
  cbs.on_accept = [fe](std::shared_ptr<h2srv::ServerConnection> c) {
    OnAccept(fe, std::move(c));
  };
  cbs.on_headers = [fe](h2srv::ServerConnection* c, uint32_t sid,
                        std::vector<hpack::Header> h, bool es) {
    OnHeaders(fe, c, sid, std::move(h), es);
  };
  cbs.on_data = [fe](h2srv::ServerConnection* c, uint32_t sid,
                     const uint8_t* d, size_t l, bool es) {
    OnData(fe, c, sid, d, l, es);
  };
  cbs.on_reset = [fe](h2srv::ServerConnection* c, uint32_t sid, uint32_t ec) {
    OnReset(fe, c, sid, ec);
  };
  cbs.on_close = [fe](h2srv::ServerConnection* c) { OnClose(fe, c); };
  std::string why;
  const bool use_tls = (tls_cert != nullptr && tls_cert[0] != '\0') ||
                       (tls_key != nullptr && tls_key[0] != '\0');
  tls::ServerOptions tls_options;
  if (use_tls) {
    tls_options.certificate_file = tls_cert != nullptr ? tls_cert : "";
    tls_options.key_file = tls_key != nullptr ? tls_key : "";
  }
  fe->listener = h2srv::Listener::Start(host, port, cbs, &why,
                                        use_tls ? &tls_options : nullptr);
  if (fe->listener == nullptr) {
    delete fe;
    if (err != nullptr && err_len > 0) {
      snprintf(err, static_cast<size_t>(err_len), "%s", why.c_str());
    }
    return 0;
  }
  std::lock_guard<std::mutex> g(g_mu);
  fe->id = g_next_frontend_id++;
  g_frontends[fe->id] = fe;
  return fe->id;
}

int ctpu_grpc_port(uint64_t id) {
  Frontend* fe = ctpu::frontend::LookupFrontend(id);
  return fe == nullptr ? -1 : fe->listener->port();
}

// Stops accepting, closes every connection and drops every pending request.
// Idempotent; ctpu_grpc_wait_events returns -1 from then on.
void ctpu_grpc_stop(uint64_t id) {
  using namespace ctpu::frontend;
  Frontend* fe = LookupFrontend(id);
  if (fe == nullptr || fe->stopped.exchange(true)) return;
  {
    std::lock_guard<std::mutex> lk(fe->q_mu);
    fe->q_stopped = true;
    fe->ready.clear();
  }
  fe->q_cv.notify_all();
  fe->listener->Stop();
  std::vector<std::unique_ptr<Pending>> dropped;
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (auto it = g_pending.begin(); it != g_pending.end();) {
      if (it->second->fe == fe) {
        dropped.push_back(std::move(it->second));
        it = g_pending.erase(it);
      } else {
        ++it;
      }
    }
  }
  dropped.clear();
  std::lock_guard<std::mutex> lk(fe->mu);
  fe->conns.clear();
  fe->streams.clear();
}

// Waits up to timeout_ms for events and packs up to max_n of them into a
// buffer the caller frees with ctpu_grpc_free. Returns their count (0 on
// timeout), or -1 once the front-end has stopped.
int ctpu_grpc_wait_events(uint64_t id, int max_n, int timeout_ms,
                          uint8_t** out, uint64_t* out_len) {
  using namespace ctpu::frontend;
  *out = nullptr;
  *out_len = 0;
  Frontend* fe = LookupFrontend(id);
  if (fe == nullptr) return -1;
  Clock::time_point next_deadline = ExpireDeadlines(fe);
  Clock::time_point until =
      Clock::now() + std::chrono::milliseconds(timeout_ms);
  if (next_deadline < until) until = next_deadline;
  std::vector<std::pair<uint8_t, uint64_t>> taken;
  {
    std::unique_lock<std::mutex> lk(fe->q_mu);
    fe->q_cv.wait_until(lk, until,
                        [fe] { return fe->q_stopped || !fe->ready.empty(); });
    if (fe->q_stopped) return -1;
    while (!fe->ready.empty() && static_cast<int>(taken.size()) < max_n) {
      taken.push_back(fe->ready.front());
      fe->ready.pop_front();
    }
  }
  ExpireDeadlines(fe);
  std::string buf;
  int count = 0;
  for (const auto& entry : taken) {
    const uint64_t handle = entry.second;
    if (entry.first == kQueueCancel) {
      AppendEvent(&buf, kEventCancel, 0, handle, 0, "", "", "");
      ++count;
      continue;
    }
    if (entry.first == kQueueStreamEnd) {
      AppendEvent(&buf, kEventStreamEnd, 0, 0, entry.second, "", "", "");
      ++count;
      continue;
    }
    std::string message;
    std::string method;
    std::string traceparent;
    uint8_t kind;
    uint8_t compression;
    uint64_t stream_key;
    {
      std::lock_guard<std::mutex> g(g_mu);
      auto it = g_pending.find(handle);
      if (it == g_pending.end()) continue;  // cancelled before delivery
      Pending* p = it->second.get();
      p->delivered = true;
      kind = p->kind;
      compression = p->compression;
      stream_key = p->stream_key;
      message.swap(p->message);
      method = p->method;
      traceparent = p->traceparent;
    }
    AppendEvent(&buf, kind, compression, handle, stream_key, method, traceparent,
                message);
    ++count;
  }
  if (count > 0) {
    *out = static_cast<uint8_t*>(malloc(buf.size()));
    if (*out == nullptr) return -1;
    memcpy(*out, buf.data(), buf.size());
    *out_len = buf.size();
  }
  return count;
}

void ctpu_grpc_free(uint8_t* p) { free(p); }

// Completes a ModelInfer or ModelStreamInfer handle: `body` is a
// serialized ModelInferResponse (unary) or ModelStreamInferResponse
// (stream). Returns 0, or -1 for a handle of another method.
int ctpu_grpc_complete(uint64_t handle, const char* body, uint64_t len,
                       int status, const char* message, int final_flag) {
  return ctpu::frontend::Complete(handle, body, len, status, message,
                                  final_flag != 0, false);
}

// Completes the handle of any other method with its serialized response
// (status 0) or its error.
int ctpu_grpc_complete_rpc(uint64_t handle, const char* body, uint64_t len,
                           int status, const char* message) {
  return ctpu::frontend::Complete(handle, body, len, status, message, true,
                                  true);
}

// ctpu_grpc_complete with its final flag set, and trailing metadata beside
// grpc-status: `metadata` holds `metadata_len` bytes of NUL-terminated
// lower-case name and value strings in turn. The extra trailers go out
// when the completion closes the call.
int ctpu_grpc_complete_with_metadata(uint64_t handle, const char* body,
                                     uint64_t len, int status,
                                     const char* message,
                                     const char* metadata,
                                     uint64_t metadata_len) {
  std::vector<ctpu::hpack::Header> extra;
  const char* end = metadata + metadata_len;
  for (const char* p = metadata; metadata != nullptr && p < end;) {
    const char* name_end = static_cast<const char*>(memchr(p, '\0', end - p));
    if (name_end == nullptr) return -1;
    const char* value = name_end + 1;
    const char* value_end =
        value < end ? static_cast<const char*>(memchr(value, '\0', end - value))
                    : nullptr;
    if (value_end == nullptr) return -1;
    extra.push_back({std::string(p, name_end), std::string(value, value_end)});
    p = value_end + 1;
  }
  return ctpu::frontend::Complete(handle, body, len, status, message, true,
                                  false, extra);
}

}  // extern "C"
