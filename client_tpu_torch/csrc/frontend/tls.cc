// Server-side TLS pump (see tls.h for the design).
//
// An own copy of the server parts of native/client/tls.cc. The libssl
// subset used here is declared locally because the machines this builds on
// have no OpenSSL development headers. Every prototype and constant below
// is part of OpenSSL 3's stable public ABI (libssl.so.3 / libcrypto.so.3);
// the symbols are resolved at run time with dlopen/dlsym, so a host
// without the runtime fails ServerContext::Create with a message instead
// of failing to link.
#include "tls.h"

#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <pthread.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

namespace ctpu {
namespace tls {

namespace {

// -- OpenSSL 3 ABI subset ----------------------------------------------------

typedef struct ssl_ctx_st SSL_CTX;
typedef struct ssl_st SSL;
typedef struct ssl_method_st SSL_METHOD;

constexpr int kSslErrorWantRead = 2;
constexpr int kSslErrorWantWrite = 3;
constexpr int kSslFiletypePem = 1;
constexpr long kSslCtrlMode = 33;
constexpr long kSslModeEnablePartialWrite = 1;
constexpr long kSslModeAcceptMovingWriteBuffer = 2;
constexpr long kSslModeAutoRetry = 4;
constexpr int kSslTlsextErrOk = 0;
constexpr int kSslTlsextErrAlertFatal = 2;

// The one protocol the listener selects, and the handshake's deadline:
// a silent or trickling client cannot pin its handshake thread longer.
const std::string kAlpn = "h2";
constexpr int64_t kHandshakeTimeoutMs = 15000;
// How long the pump keeps flushing to a TLS peer after the h2 side has
// closed: a peer that stops reading cannot keep the pump thread alive.
constexpr int64_t kFlushAfterCloseMs = 5000;

using AlpnSelectCb = int (*)(SSL*, const unsigned char**, unsigned char*,
                             const unsigned char*, unsigned int, void*);

struct Api {
  void* libssl = nullptr;
  void* libcrypto = nullptr;

  int (*OPENSSL_init_ssl)(uint64_t, const void*) = nullptr;
  const SSL_METHOD* (*TLS_server_method)() = nullptr;
  SSL_CTX* (*SSL_CTX_new)(const SSL_METHOD*) = nullptr;
  void (*SSL_CTX_free)(SSL_CTX*) = nullptr;
  long (*SSL_CTX_ctrl)(SSL_CTX*, int, long, void*) = nullptr;
  int (*SSL_CTX_use_certificate_chain_file)(SSL_CTX*, const char*) = nullptr;
  int (*SSL_CTX_use_PrivateKey_file)(SSL_CTX*, const char*, int) = nullptr;
  int (*SSL_CTX_check_private_key)(const SSL_CTX*) = nullptr;
  void (*SSL_CTX_set_alpn_select_cb)(SSL_CTX*, AlpnSelectCb, void*) = nullptr;
  SSL* (*SSL_new)(SSL_CTX*) = nullptr;
  void (*SSL_free)(SSL*) = nullptr;
  int (*SSL_set_fd)(SSL*, int) = nullptr;
  int (*SSL_accept)(SSL*) = nullptr;
  int (*SSL_read)(SSL*, void*, int) = nullptr;
  int (*SSL_write)(SSL*, const void*, int) = nullptr;
  int (*SSL_shutdown)(SSL*) = nullptr;
  int (*SSL_get_error)(const SSL*, int) = nullptr;
  void (*SSL_get0_alpn_selected)(const SSL*, const unsigned char**,
                                 unsigned int*) = nullptr;
  unsigned long (*ERR_get_error)() = nullptr;
  void (*ERR_error_string_n)(unsigned long, char*, size_t) = nullptr;

  std::string load_error;

  template <typename T>
  bool Sym(void* lib, const char* name, T* out) {
    *out = reinterpret_cast<T>(dlsym(lib, name));
    if (*out == nullptr) {
      load_error = std::string("missing OpenSSL symbol ") + name;
      return false;
    }
    return true;
  }

  bool Load() {
    libssl = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (libssl == nullptr) {
      load_error = "libssl.so.3 could not be loaded (dlopen failed)";
      return false;
    }
    libcrypto = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (libcrypto == nullptr) {
      load_error = "libcrypto.so.3 could not be loaded (dlopen failed)";
      return false;
    }
#define CTPU_TLS_SYM(lib, name) \
  if (!Sym(lib, #name, &name)) return false
    CTPU_TLS_SYM(libssl, OPENSSL_init_ssl);
    CTPU_TLS_SYM(libssl, TLS_server_method);
    CTPU_TLS_SYM(libssl, SSL_CTX_new);
    CTPU_TLS_SYM(libssl, SSL_CTX_free);
    CTPU_TLS_SYM(libssl, SSL_CTX_ctrl);
    CTPU_TLS_SYM(libssl, SSL_CTX_use_certificate_chain_file);
    CTPU_TLS_SYM(libssl, SSL_CTX_use_PrivateKey_file);
    CTPU_TLS_SYM(libssl, SSL_CTX_check_private_key);
    CTPU_TLS_SYM(libssl, SSL_CTX_set_alpn_select_cb);
    CTPU_TLS_SYM(libssl, SSL_new);
    CTPU_TLS_SYM(libssl, SSL_free);
    CTPU_TLS_SYM(libssl, SSL_set_fd);
    CTPU_TLS_SYM(libssl, SSL_accept);
    CTPU_TLS_SYM(libssl, SSL_read);
    CTPU_TLS_SYM(libssl, SSL_write);
    CTPU_TLS_SYM(libssl, SSL_shutdown);
    CTPU_TLS_SYM(libssl, SSL_get_error);
    CTPU_TLS_SYM(libssl, SSL_get0_alpn_selected);
    CTPU_TLS_SYM(libcrypto, ERR_get_error);
    CTPU_TLS_SYM(libcrypto, ERR_error_string_n);
#undef CTPU_TLS_SYM
    OPENSSL_init_ssl(0, nullptr);
    return true;
  }
};

// Loaded once for the process; a failed load keeps its message.
Api* GetApi() {
  static Api* api = [] {
    auto* a = new Api();
    a->Load();
    return a;
  }();
  return api;
}

bool ApiReady(std::string* err) {
  Api* api = GetApi();
  if (api->ERR_error_string_n == nullptr) {
    if (err != nullptr) *err = api->load_error;
    return false;
  }
  return true;
}

std::string LastSslError(const char* what) {
  Api* api = GetApi();
  char buf[256];
  unsigned long code = api->ERR_get_error();
  if (code == 0) return std::string(what);
  api->ERR_error_string_n(code, buf, sizeof(buf));
  // drain the rest of the error queue so it cannot bleed into later calls
  while (api->ERR_get_error() != 0) {
  }
  return std::string(what) + ": " + buf;
}

// OpenSSL writes with plain write(), which raises SIGPIPE on a closed
// peer. Blocks SIGPIPE for the current thread so SSL_write/SSL_shutdown
// get EPIPE instead; any SIGPIPE that became pending while blocked is
// consumed before the mask is restored.
class SigpipeGuard {
 public:
  SigpipeGuard() {
    sigset_t set;
    sigemptyset(&set);
    sigaddset(&set, SIGPIPE);
    blocked_ = pthread_sigmask(SIG_BLOCK, &set, &old_) == 0 &&
               !sigismember(&old_, SIGPIPE);
  }
  ~SigpipeGuard() {
    if (!blocked_) return;
    sigset_t set;
    sigemptyset(&set);
    sigaddset(&set, SIGPIPE);
    struct timespec zero = {0, 0};
    while (sigtimedwait(&set, nullptr, &zero) > 0) {
    }
    pthread_sigmask(SIG_SETMASK, &old_, nullptr);
  }

 private:
  sigset_t old_;
  bool blocked_ = false;
};

// -- the pump ----------------------------------------------------------------

int64_t NowMs() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

// Owns the SSL session and the encrypted fd; shuttles bytes between them
// and the plaintext socketpair end until either side closes. Every SSL
// call happens on this one thread. TLS records need not line up with
// HTTP/2 frames: the pump moves bytes, and the h2 reader reassembles
// frames from the plaintext stream as it does from TCP.
void PumpLoop(Api* api, SSL* ssl, int tls_fd, int plain_fd) {
  SigpipeGuard sigpipe;  // the pump owns this thread
  // Nonblocking TLS side; the plaintext side stays blocking (its peer is
  // the in-process h2 connection, which drains promptly).
  fcntl(tls_fd, F_SETFL, fcntl(tls_fd, F_GETFL, 0) | O_NONBLOCK);
  std::vector<char> outbuf;  // plaintext bytes pending SSL_write
  size_t out_off = 0;
  bool want_tls_write = false;
  // Set once the h2 side hangs up while outbuf still holds bytes: poll
  // reports POLLHUP on plain_fd whatever is asked for, so the pump stops
  // watching it (no busy loop) and gives the flush a deadline.
  int64_t flush_deadline_ms = -1;
  char buf[32 * 1024];
  for (;;) {
    struct pollfd fds[2];
    fds[0].fd = tls_fd;
    fds[0].events = static_cast<short>(POLLIN | (want_tls_write ? POLLOUT : 0));
    fds[0].revents = 0;
    fds[1].fd = flush_deadline_ms < 0 ? plain_fd : -1;
    fds[1].events = static_cast<short>(outbuf.empty() ? POLLIN : 0);
    fds[1].revents = 0;
    int timeout_ms = -1;
    if (flush_deadline_ms >= 0) {
      const int64_t left_ms = flush_deadline_ms - NowMs();
      if (left_ms <= 0) goto done;  // the peer stopped reading: drop the rest
      timeout_ms = static_cast<int>(left_ms);
    }
    if (poll(fds, 2, timeout_ms) < 0) {
      if (errno == EINTR) continue;
      break;
    }
    want_tls_write = false;
    if (!outbuf.empty() && (fds[1].revents & (POLLHUP | POLLERR))) {
      flush_deadline_ms = NowMs() + kFlushAfterCloseMs;
    }
    // TLS -> plaintext
    if (fds[0].revents & (POLLIN | POLLHUP | POLLERR | POLLOUT)) {
      for (;;) {
        int n = api->SSL_read(ssl, buf, sizeof(buf));
        if (n > 0) {
          const char* p = buf;
          size_t left = static_cast<size_t>(n);
          while (left > 0) {
            ssize_t w = ::send(plain_fd, p, left, MSG_NOSIGNAL);
            if (w < 0 && errno == EINTR) continue;
            if (w <= 0) goto done;
            p += w;
            left -= static_cast<size_t>(w);
          }
          continue;
        }
        int e = api->SSL_get_error(ssl, n);
        if (e == kSslErrorWantRead) break;
        if (e == kSslErrorWantWrite) {
          want_tls_write = true;
          break;
        }
        goto done;  // close_notify, a syscall error, or a fatal alert
      }
    }
    // plaintext -> TLS
    if (outbuf.empty() && (fds[1].revents & (POLLIN | POLLHUP | POLLERR))) {
      ssize_t n;
      do {
        n = ::recv(plain_fd, buf, sizeof(buf), 0);
      } while (n < 0 && errno == EINTR);
      if (n <= 0) goto done;  // the h2 side closed: wind down
      outbuf.assign(buf, buf + n);
      out_off = 0;
    }
    while (out_off < outbuf.size()) {
      int n = api->SSL_write(ssl, outbuf.data() + out_off,
                             static_cast<int>(outbuf.size() - out_off));
      if (n > 0) {
        out_off += static_cast<size_t>(n);
        continue;
      }
      int e = api->SSL_get_error(ssl, n);
      if (e == kSslErrorWantRead) break;  // renegotiation data pending
      if (e == kSslErrorWantWrite) {
        want_tls_write = true;
        break;
      }
      goto done;
    }
    if (out_off >= outbuf.size()) {
      outbuf.clear();
      out_off = 0;
      // flushed: read plain_fd again, to its remaining bytes and its end
      flush_deadline_ms = -1;
    }
  }
done:
  api->SSL_shutdown(ssl);  // best-effort close_notify
  api->SSL_free(ssl);
  ::close(tls_fd);
  ::close(plain_fd);
}

// Nonblocking accept handshake with an ABSOLUTE deadline: a per-read
// timeout would let a trickling client keep it alive indefinitely (and
// wedge the listener's shutdown, which waits for in-flight handshakes).
// Leaves the fd nonblocking, as the pump wants it.
bool AcceptWithDeadline(Api* api, SSL* ssl, int fd, int64_t timeout_ms,
                        std::string* err) {
  fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
  const int64_t deadline_ms = NowMs() + timeout_ms;
  for (;;) {
    int rc = api->SSL_accept(ssl);
    if (rc == 1) return true;
    int e = api->SSL_get_error(ssl, rc);
    if (e != kSslErrorWantRead && e != kSslErrorWantWrite) {
      *err = LastSslError("TLS accept handshake failed");
      return false;
    }
    const int64_t now_ms = NowMs();
    if (now_ms >= deadline_ms) {
      *err = "TLS handshake timed out";
      return false;
    }
    struct pollfd pfd;
    pfd.fd = fd;
    pfd.events = e == kSslErrorWantRead ? POLLIN : POLLOUT;
    pfd.revents = 0;
    int prc = poll(&pfd, 1, static_cast<int>(deadline_ms - now_ms));
    if (prc < 0 && errno != EINTR) {
      *err = "TLS handshake poll failed";
      return false;
    }
    if (prc == 0) {
      *err = "TLS handshake timed out";
      return false;
    }
  }
}

// ALPN select callback: accept exactly kAlpn.
int AlpnSelect(SSL*, const unsigned char** out, unsigned char* outlen,
               const unsigned char* in, unsigned int inlen, void*) {
  unsigned int i = 0;
  while (i < inlen) {
    unsigned int len = in[i];
    if (i + 1 + len > inlen) break;
    if (len == kAlpn.size() && memcmp(in + i + 1, kAlpn.data(), len) == 0) {
      *out = in + i + 1;
      *outlen = static_cast<unsigned char>(len);
      return kSslTlsextErrOk;
    }
    i += 1 + len;
  }
  return kSslTlsextErrAlertFatal;
}

}  // namespace

ServerContext* ServerContext::Create(const ServerOptions& options,
                                     std::string* err) {
  if (!ApiReady(err)) return nullptr;
  Api* api = GetApi();
  SSL_CTX* ctx = api->SSL_CTX_new(api->TLS_server_method());
  if (ctx == nullptr) {
    *err = LastSslError("SSL_CTX_new failed");
    return nullptr;
  }
  // Partial writes and auto-retry keep the pump's state machine simple.
  api->SSL_CTX_ctrl(ctx, kSslCtrlMode,
                    kSslModeEnablePartialWrite |
                        kSslModeAcceptMovingWriteBuffer | kSslModeAutoRetry,
                    nullptr);
  if (api->SSL_CTX_use_certificate_chain_file(
          ctx, options.certificate_file.c_str()) != 1) {
    *err = LastSslError(
        ("loading the server certificate " + options.certificate_file +
         " failed")
            .c_str());
    api->SSL_CTX_free(ctx);
    return nullptr;
  }
  if (api->SSL_CTX_use_PrivateKey_file(ctx, options.key_file.c_str(),
                                       kSslFiletypePem) != 1 ||
      api->SSL_CTX_check_private_key(ctx) != 1) {
    *err = LastSslError(
        ("loading the server key " + options.key_file + " failed").c_str());
    api->SSL_CTX_free(ctx);
    return nullptr;
  }
  api->SSL_CTX_set_alpn_select_cb(ctx, AlpnSelect, nullptr);
  auto* sc = new ServerContext();
  sc->ctx_ = ctx;
  return sc;
}

ServerContext::~ServerContext() {
  if (ctx_ != nullptr) {
    GetApi()->SSL_CTX_free(static_cast<SSL_CTX*>(ctx_));
  }
}

int ServerContext::WrapAccepted(int tcp_fd, std::string* err) {
  Api* api = GetApi();
  SSL* ssl = api->SSL_new(static_cast<SSL_CTX*>(ctx_));
  if (ssl == nullptr) {
    *err = LastSslError("SSL_new failed");
    ::close(tcp_fd);
    return -1;
  }
  api->SSL_set_fd(ssl, tcp_fd);
  SigpipeGuard sigpipe;  // the handshake writes on the caller's thread
  if (!AcceptWithDeadline(api, ssl, tcp_fd, kHandshakeTimeoutMs, err)) {
    api->SSL_free(ssl);
    ::close(tcp_fd);
    return -1;
  }
  // a client that offered no ALPN at all never reached the callback
  const unsigned char* proto = nullptr;
  unsigned int proto_len = 0;
  api->SSL_get0_alpn_selected(ssl, &proto, &proto_len);
  if (proto_len != kAlpn.size() || memcmp(proto, kAlpn.data(), proto_len) != 0) {
    *err = "TLS peer did not negotiate ALPN '" + kAlpn + "'";
    api->SSL_free(ssl);
    ::close(tcp_fd);
    return -1;
  }
  int pair[2];
  if (socketpair(AF_UNIX, SOCK_STREAM, 0, pair) != 0) {
    *err = "socketpair failed";
    api->SSL_free(ssl);
    ::close(tcp_fd);
    return -1;
  }
  std::thread([api, ssl, tcp_fd, pump_fd = pair[1]] {
    pthread_setname_np(pthread_self(), "ctpu-tls-pump");
    PumpLoop(api, ssl, tcp_fd, pump_fd);
  }).detach();
  return pair[0];
}

}  // namespace tls
}  // namespace ctpu
