// Server-side TLS for the native h2 front-end.
//
// An own copy of the server half of native/client/tls.h. The listener
// hands each accepted TCP socket to a ServerContext, which runs the TLS
// handshake against an absolute deadline and then starts a pump thread
// that owns the socket and the OpenSSL session and shuttles bytes to and
// from a plaintext socketpair. The h2 connection reads and writes the
// plaintext end exactly as it would a raw TCP socket, so the HTTP/2 code
// needs no change, and no SSL object is ever touched by two threads
// (OpenSSL's session handles are not thread-safe).
//
// OpenSSL is loaded at run time with dlopen("libssl.so.3"): the machines
// this builds on ship the runtime library but no development headers, so
// tls.cc declares the subset of the stable OpenSSL 3 ABI it calls.
#pragma once

#include <string>

namespace ctpu {
namespace tls {

// Server-side TLS configuration (PEM file paths). The listener selects
// ALPN "h2": a client that does not offer it fails the handshake.
struct ServerOptions {
  std::string certificate_file;  // server certificate chain
  std::string key_file;          // server private key
};

// One TLS context per listener (it owns one SSL_CTX, freed with it).
class ServerContext {
 public:
  // Loads the certificate chain and key. Returns nullptr with *err set
  // when libssl.so.3 cannot be loaded or a PEM cannot be read or does not
  // match.
  static ServerContext* Create(const ServerOptions& options, std::string* err);
  ~ServerContext();

  // The accept-side handshake (bounded by an absolute 15 s deadline), then
  // the pump thread. Returns the plaintext fd, or -1 with *err set. Takes
  // ownership of tcp_fd either way.
  int WrapAccepted(int tcp_fd, std::string* err);

 private:
  ServerContext() = default;
  void* ctx_ = nullptr;  // SSL_CTX*
};

}  // namespace tls
}  // namespace ctpu
