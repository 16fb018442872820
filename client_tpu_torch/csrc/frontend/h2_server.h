// Server-side HTTP/2 (RFC 7540) for the native gRPC front-end.
//
// An own copy of native/frontend/h2_server.h: h2c, or TLS with ALPN h2
// when the listener is given a certificate and key (tls.h).
//
// The reference project serves gRPC through tritonserver's grpc++ endpoint
// (reference: server-side; its client repo only consumes it). This framework
// terminates gRPC in-process over its own h2c implementation — the server
// twin of the hand-rolled client connection in native/client/h2.{h,cc} —
// so the Python inference core behind it never touches wire parsing.
//
// Threading model (mirrors the client): one reader thread per connection
// parses frames and fires callbacks; one writer thread per connection drains
// a response queue honoring send flow control. All public send methods are
// thread-safe and may be called from any thread (including the Python event
// loop completing an inference).
#pragma once

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include "hpack.h"
#include "tls.h"

namespace ctpu {
namespace h2srv {

class ServerConnection;

// Callbacks fired on the connection's reader thread (on_accept on the
// acceptor thread). The receiver must not block on the connection's own
// writer (sends are queue-and-return, so calling Send* from a callback is
// fine).
struct ConnectionCallbacks {
  // A connection was accepted; the shared_ptr may be retained to keep the
  // object alive past the Listener's ownership.
  std::function<void(std::shared_ptr<ServerConnection>)> on_accept;
  // A request header block completed on `stream_id`.
  std::function<void(ServerConnection*, uint32_t stream_id,
                     std::vector<hpack::Header> headers, bool end_stream)>
      on_headers;
  // DATA received on an open stream.
  std::function<void(ServerConnection*, uint32_t stream_id,
                     const uint8_t* data, size_t len, bool end_stream)>
      on_data;
  // Peer reset the stream.
  std::function<void(ServerConnection*, uint32_t stream_id,
                     uint32_t error_code)>
      on_reset;
  // Connection is done (socket closed / fatal protocol error). Fired once,
  // after which no further callbacks arrive.
  std::function<void(ServerConnection*)> on_close;
};

class ServerConnection {
 public:
  // Takes ownership of a connected socket that has NOT yet consumed the
  // client preface. Does NOT start the reader/writer threads — the caller
  // must invoke StartThreads() after any registration that callbacks rely
  // on (otherwise a fast first request races the registration).
  static std::shared_ptr<ServerConnection> Adopt(int fd,
                                                 ConnectionCallbacks cbs);
  void StartThreads();
  ~ServerConnection();

  // All Send* methods enqueue and return immediately; they are no-ops on a
  // dead connection or a stream the peer has reset.
  void SendHeaders(uint32_t stream_id,
                   const std::vector<hpack::Header>& headers, bool end_stream);
  // `data` is moved into the queue; chunked to flow-control and frame-size
  // limits by the writer thread.
  void SendData(uint32_t stream_id, std::string data, bool end_stream);
  void SendTrailers(uint32_t stream_id,
                    const std::vector<hpack::Header>& trailers);
  // One-lock, one-wakeup enqueue of a response bundle: optional HEADERS
  // (null = already sent), optional DATA (null = trailers-only), optional
  // TRAILERS (null = stream stays open, streaming). Equivalent to calling
  // SendHeaders + SendData + SendTrailers back-to-back, but the writer
  // wakes once with every frame queued, so a unary gRPC response costs one
  // condvar signal and usually one send() instead of three of each.
  void SendResponse(uint32_t stream_id,
                    const std::vector<hpack::Header>* headers,
                    std::string* data,
                    const std::vector<hpack::Header>* trailers);
  void SendReset(uint32_t stream_id, uint32_t error_code);

  bool alive() const { return !dead_.load(); }
  // Half-closes the socket; reader/writer wind down and on_close fires.
  void Shutdown();
  // Joins the reader/writer threads. Must not be called from either.
  void Join();

 private:
  ServerConnection() = default;

  struct StreamState {
    int64_t send_window = 65535;
    int64_t recv_consumed = 0;
    bool remote_done = false;  // END_STREAM received
    bool local_done = false;   // we sent END_STREAM
    bool reset = false;        // RST sent or received
  };

  enum class ItemKind { kRaw, kHeaders, kData, kTrailers };
  struct WriteItem {
    ItemKind kind;
    uint32_t stream_id = 0;
    std::string payload;  // kRaw: pre-framed bytes; kData: message bytes
    std::vector<hpack::Header> headers;
    bool end_stream = false;
    size_t offset = 0;  // kData: bytes already written
  };

  void ReaderLoop();
  void WriterLoop();
  size_t FindWritableLocked();
  bool EncodeItemLocked(size_t idx, std::string* out);
  bool ReadN(uint8_t* buf, size_t len);
  bool WriteAll(const void* data, size_t len);
  void HandleFrame(uint8_t type, uint8_t flags, uint32_t stream_id,
                   const uint8_t* payload, size_t len);
  void DispatchHeaderBlock(uint32_t stream_id, bool end_stream);
  void EnqueueRawLocked(std::string frame);  // control frames, queue front
  void EnqueueRaw(std::string frame);
  void Fatal(uint32_t error_code, const std::string& reason);
  void MaybeSendWindowUpdates(uint32_t stream_id);
  StreamState* GetStream(uint32_t stream_id);  // mu_ held

  int fd_ = -1;
  // ReadN's recv buffer (reader-thread only).
  std::vector<uint8_t> rbuf_;
  size_t roff_ = 0;
  size_t rlen_ = 0;
  std::atomic<bool> dead_{false};
  std::atomic<bool> close_fired_{false};
  ConnectionCallbacks cbs_;
  std::thread reader_;
  std::thread writer_;

  std::mutex mu_;  // streams, windows, hpack decoder, settings
  std::map<uint32_t, StreamState> streams_;
  // Streams fully closed (both sides done or reset) — kept as ids so a
  // late Send on a finished stream is dropped rather than re-opening it.
  std::set<uint32_t> closed_streams_;
  uint32_t max_seen_stream_ = 0;
  int64_t conn_send_window_ = 65535;
  int64_t conn_recv_consumed_ = 0;
  uint32_t peer_max_frame_ = 16384;
  uint32_t peer_initial_window_ = 65535;
  hpack::Decoder decoder_;

  // CONTINUATION reassembly.
  std::string header_block_;
  uint32_t header_block_stream_ = 0;
  bool header_block_end_stream_ = false;
  bool in_header_block_ = false;

  // Writer queue.
  std::mutex wq_mu_;
  std::condition_variable wq_cv_;
  std::deque<WriteItem> wq_;
  bool writer_stop_ = false;
};

// Accepts connections and owns them until Stop().
class Listener {
 public:
  // Binds host:port (port 0 picks a free port). Returns nullptr + *err on
  // failure. `cbs` is shared by every accepted connection. With `tls`,
  // accepted sockets handshake TLS (ALPN h2) before h2 adoption; the
  // handshake runs on a per-connection thread so a slow client can never
  // stall the accept loop. The listener owns its one TLS context.
  static std::unique_ptr<Listener> Start(const std::string& host, int port,
                                         ConnectionCallbacks cbs,
                                         std::string* err,
                                         const tls::ServerOptions* tls =
                                             nullptr);
  ~Listener();

  int port() const { return port_; }
  void Stop();

 private:
  Listener() = default;
  void AcceptLoop();
  void AdoptAccepted(int fd);
  void Reap(bool all);

  // Atomic: Stop() shuts the socket down from another thread while
  // AcceptLoop blocks in accept() on it (close happens only after join).
  std::atomic<int> listen_fd_{-1};
  int port_ = 0;
  ConnectionCallbacks cbs_;
  std::thread acceptor_;
  std::atomic<bool> stopping_{false};

  std::mutex mu_;
  std::vector<std::shared_ptr<ServerConnection>> conns_;

  std::unique_ptr<tls::ServerContext> tls_ctx_;
  // In-flight TLS handshake threads; Stop() drains them (each is bounded
  // by the handshake's absolute deadline, so the wait is finite).
  std::mutex hs_mu_;
  std::condition_variable hs_cv_;
  size_t hs_inflight_ = 0;
};

}  // namespace h2srv
}  // namespace ctpu
