// Parameter-server core: a standalone TCP server process hosting dense and
// sparse (hash) parameter tables with row-wise optimizer appliers.
//
// reference parity: paddle/fluid/distributed/service/brpc_ps_server.h
// (PsService::service dispatch), distributed/table/common_dense_table.cc
// (dense pull/push + sgd/adam appliers), common_sparse_table.cc (shard
// hash tables, lazy row init, pull_sparse/push_sparse_grad),
// service/communicator.cc (the async client lives in python).
//
// TPU-native redesign notes: the accelerator never talks to this process —
// workers pull rows into host numpy buffers, feed them to jitted steps as
// ordinary inputs, and push gradients back. The server is therefore plain
// portable C++ (sockets + threads, no RDMA/brpc): on a TPU pod the hosts'
// commodity NICs and DCN carry this traffic, and the hot math (row apply)
// is a contiguous float loop the compiler vectorizes.
//
// Protocol (little-endian):
//   request  = [u8 op][u32 table_id][u64 nbytes][payload]
//   response = [u8 status][u64 nbytes][payload]    status: 0 ok, 1 error
// Ops: 0 ping, 1 create_table, 2 pull_dense, 3 push_dense(set),
//      4 push_dense_grad, 5 pull_sparse, 6 push_sparse_grad,
//      7 push_sparse(set), 8 save, 9 load, 10 stats, 11 stop.
//
// Build: g++ -O2 -std=c++17 -pthread ps_server.cpp -o ps_server

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <chrono>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumShards = 16;  // lock striping for concurrent clients

enum Op : uint8_t {
  kPing = 0,
  kCreateTable = 1,
  kPullDense = 2,
  kPushDense = 3,
  kPushDenseGrad = 4,
  kPullSparse = 5,
  kPushSparseGrad = 6,
  kPushSparse = 7,
  kSave = 8,
  kLoad = 9,
  kStats = 10,
  kStop = 11,
  kKind = 12,
  kAddSparse = 13,   // w[key] += delta (geo-SGD aggregation)
};

enum OptKind : uint8_t { kSGD = 0, kAdagrad = 1, kAdam = 2 };

// splitmix64: deterministic per-(seed, key) row init, same rows no matter
// which server/shard ends up owning a key.
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

inline float uniform_from(uint64_t h, float scale) {
  // top 24 bits -> [0, 1) -> [-scale, scale)
  float u = static_cast<float>(h >> 40) * (1.0f / 16777216.0f);
  return (2.0f * u - 1.0f) * scale;
}

struct OptConfig {
  OptKind kind = kSGD;
  float lr = 0.05f;
  // adam hyperparameters (fixed defaults, matching the reference ops)
  float beta1 = 0.9f, beta2 = 0.999f, eps = 1e-8f;
};

// state floats per weight for each optimizer
inline int slots_per_dim(OptKind k) {
  switch (k) {
    case kSGD: return 0;
    case kAdagrad: return 1;   // g2 accumulator
    case kAdam: return 2;      // m, v
  }
  return 0;
}

void apply_row(const OptConfig& opt, float* w, float* state, const float* g,
               uint64_t dim, uint64_t t) {
  switch (opt.kind) {
    case kSGD:
      for (uint64_t i = 0; i < dim; ++i) w[i] -= opt.lr * g[i];
      break;
    case kAdagrad:
      for (uint64_t i = 0; i < dim; ++i) {
        state[i] += g[i] * g[i];
        w[i] -= opt.lr * g[i] / (std::sqrt(state[i]) + 1e-6f);
      }
      break;
    case kAdam: {
      float* m = state;
      float* v = state + dim;
      float bc1 = 1.0f - std::pow(opt.beta1, static_cast<float>(t));
      float bc2 = 1.0f - std::pow(opt.beta2, static_cast<float>(t));
      for (uint64_t i = 0; i < dim; ++i) {
        m[i] = opt.beta1 * m[i] + (1.0f - opt.beta1) * g[i];
        v[i] = opt.beta2 * v[i] + (1.0f - opt.beta2) * g[i] * g[i];
        w[i] -= opt.lr * (m[i] / bc1) / (std::sqrt(v[i] / bc2) + opt.eps);
      }
      break;
    }
  }
}

struct DenseTable {
  uint64_t rows = 0, dim = 0;
  OptConfig opt;
  uint64_t step = 0;
  std::vector<float> w, state;
  std::mutex mu;
};

struct SparseShard {
  std::unordered_map<uint64_t, uint32_t> index;  // key -> row slot
  std::vector<float> w;      // slot * dim
  std::vector<float> state;  // slot * dim * slots_per_dim
  std::vector<uint64_t> keys;  // slot -> key (for save)
  std::mutex mu;
};

struct SparseTable {
  uint64_t dim = 0;
  OptConfig opt;
  uint32_t seed = 0;
  float init_scale = 0.01f;
  std::atomic<uint64_t> step{0};
  SparseShard shards[kNumShards];

  // returns pointer to the row, creating (deterministic init) if absent.
  // caller must hold the shard lock.
  float* row(SparseShard& sh, uint64_t key) {
    auto it = sh.index.find(key);
    uint32_t slot;
    if (it == sh.index.end()) {
      slot = static_cast<uint32_t>(sh.keys.size());
      sh.index.emplace(key, slot);
      sh.keys.push_back(key);
      sh.w.resize(sh.w.size() + dim);
      sh.state.resize(sh.state.size() + dim * slots_per_dim(opt.kind), 0.f);
      float* w = &sh.w[static_cast<size_t>(slot) * dim];
      for (uint64_t i = 0; i < dim; ++i)
        w[i] = uniform_from(mix64((uint64_t(seed) << 32) ^ mix64(key) ^ i),
                            init_scale);
      return w;
    }
    slot = it->second;
    return &sh.w[static_cast<size_t>(slot) * dim];
  }
  float* row_state(SparseShard& sh, uint64_t key) {
    int spd = slots_per_dim(opt.kind);
    if (spd == 0) return nullptr;
    return &sh.state[static_cast<size_t>(sh.index[key]) * dim * spd];
  }
  static int shard_of(uint64_t key) {
    return static_cast<int>(mix64(key) % kNumShards);
  }
};

struct Server {
  std::unordered_map<uint32_t, std::unique_ptr<DenseTable>> dense;
  std::unordered_map<uint32_t, std::unique_ptr<SparseTable>> sparse;
  std::mutex tables_mu;
  std::atomic<bool> stop{false};
  std::atomic<int> active_conns{0};
  int listen_fd = -1;

  DenseTable* dense_at(uint32_t id) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = dense.find(id);
    return it == dense.end() ? nullptr : it->second.get();
  }
  SparseTable* sparse_at(uint32_t id) {
    std::lock_guard<std::mutex> g(tables_mu);
    auto it = sparse.find(id);
    return it == sparse.end() ? nullptr : it->second.get();
  }
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool respond(int fd, uint8_t status, const void* payload, uint64_t n) {
  char hdr[9];
  hdr[0] = static_cast<char>(status);
  std::memcpy(hdr + 1, &n, 8);
  if (!write_full(fd, hdr, 9)) return false;
  if (n && !write_full(fd, payload, n)) return false;
  return true;
}

bool respond_err(int fd, const std::string& msg) {
  return respond(fd, 1, msg.data(), msg.size());
}

template <typename T>
T rd(const char*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

void handle_create(Server& srv, const std::vector<char>& body, uint32_t id,
                   int fd) {
  const char* p = body.data();
  uint8_t kind = rd<uint8_t>(p);
  OptConfig opt;
  opt.kind = static_cast<OptKind>(rd<uint8_t>(p));
  opt.lr = rd<float>(p);
  uint64_t dim = rd<uint64_t>(p);
  uint64_t rows = rd<uint64_t>(p);
  uint32_t seed = rd<uint32_t>(p);
  float init_scale = rd<float>(p);
  std::lock_guard<std::mutex> g(srv.tables_mu);
  if (kind == 0) {
    auto t = std::make_unique<DenseTable>();
    t->rows = rows;
    t->dim = dim;
    t->opt = opt;
    t->w.resize(rows * dim);
    for (uint64_t i = 0; i < rows * dim; ++i)
      t->w[i] = uniform_from(mix64((uint64_t(seed) << 32) ^ i), init_scale);
    t->state.resize(rows * dim * slots_per_dim(opt.kind), 0.f);
    srv.dense[id] = std::move(t);
  } else {
    auto t = std::make_unique<SparseTable>();
    t->dim = dim;
    t->opt = opt;
    t->seed = seed;
    t->init_scale = init_scale;
    srv.sparse[id] = std::move(t);
  }
  respond(fd, 0, nullptr, 0);
}

void handle_pull_sparse(SparseTable& t, const std::vector<char>& body,
                        int fd) {
  if (body.size() < 8) { respond_err(fd, "short request"); return; }
  const char* p = body.data();
  uint64_t n = rd<uint64_t>(p);
  // bound BEFORE multiplying: wire-controlled n must not overflow
  if (n > (body.size() - 8) / 8 || body.size() != 8 + n * 8) {
    respond_err(fd, "pull_sparse size mismatch");
    return;
  }
  const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
  std::vector<float> out(n * t.dim);
  for (uint64_t i = 0; i < n; ++i) {
    SparseShard& sh = t.shards[SparseTable::shard_of(keys[i])];
    std::lock_guard<std::mutex> g(sh.mu);
    const float* w = t.row(sh, keys[i]);
    std::memcpy(&out[i * t.dim], w, t.dim * sizeof(float));
  }
  respond(fd, 0, out.data(), out.size() * sizeof(float));
}

void handle_add_sparse(SparseTable& t, const std::vector<char>& body,
                       int fd) {
  // geo-SGD: workers train locally and push PARAMETER DELTAS which are
  // summed into the global table (reference: distributed/table geo mode,
  // communicator.cc GeoCommunicator).
  if (body.size() < 8) { respond_err(fd, "short request"); return; }
  const char* p = body.data();
  uint64_t n = rd<uint64_t>(p);
  if (n > (body.size() - 8) / 8 ||
      body.size() != 8 + n * 8 + n * t.dim * sizeof(float)) {
    respond_err(fd, "add_sparse size mismatch");
    return;
  }
  const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
  const float* vals =
      reinterpret_cast<const float*>(p + n * sizeof(uint64_t));
  for (uint64_t i = 0; i < n; ++i) {
    SparseShard& sh = t.shards[SparseTable::shard_of(keys[i])];
    std::lock_guard<std::mutex> g(sh.mu);
    float* w = t.row(sh, keys[i]);
    for (uint64_t d = 0; d < t.dim; ++d) w[d] += vals[i * t.dim + d];
  }
  respond(fd, 0, nullptr, 0);
}

void handle_push_sparse(SparseTable& t, const std::vector<char>& body,
                        bool is_grad, int fd) {
  if (body.size() < 8) { respond_err(fd, "short request"); return; }
  const char* p = body.data();
  uint64_t n = rd<uint64_t>(p);
  if (n > (body.size() - 8) / 8 ||
      body.size() != 8 + n * 8 + n * t.dim * sizeof(float)) {
    respond_err(fd, "push_sparse size mismatch");
    return;
  }
  const uint64_t* keys = reinterpret_cast<const uint64_t*>(p);
  const float* vals =
      reinterpret_cast<const float*>(p + n * sizeof(uint64_t));
  uint64_t step = is_grad ? t.step.fetch_add(1) + 1 : 0;
  for (uint64_t i = 0; i < n; ++i) {
    SparseShard& sh = t.shards[SparseTable::shard_of(keys[i])];
    std::lock_guard<std::mutex> g(sh.mu);
    float* w = t.row(sh, keys[i]);
    if (is_grad) {
      apply_row(t.opt, w, t.row_state(sh, keys[i]), &vals[i * t.dim], t.dim,
                step);
    } else {
      std::memcpy(w, &vals[i * t.dim], t.dim * sizeof(float));
    }
  }
  respond(fd, 0, nullptr, 0);
}

void handle_save(Server& srv, const std::vector<char>& body, uint32_t id,
                 int fd) {
  std::string path(body.begin(), body.end());
  std::ofstream f(path, std::ios::binary);
  if (!f) {
    respond_err(fd, "cannot open " + path);
    return;
  }
  if (DenseTable* t = srv.dense_at(id)) {
    std::lock_guard<std::mutex> g(t->mu);
    uint8_t kind = 0;
    f.write(reinterpret_cast<const char*>(&kind), 1);
    f.write(reinterpret_cast<const char*>(&t->rows), 8);
    f.write(reinterpret_cast<const char*>(&t->dim), 8);
    f.write(reinterpret_cast<const char*>(t->w.data()),
            t->w.size() * sizeof(float));
    f.write(reinterpret_cast<const char*>(t->state.data()),
            t->state.size() * sizeof(float));
  } else if (SparseTable* t = srv.sparse_at(id)) {
    uint8_t kind = 1;
    f.write(reinterpret_cast<const char*>(&kind), 1);
    f.write(reinterpret_cast<const char*>(&t->dim), 8);
    int spd = slots_per_dim(t->opt.kind);
    for (auto& sh : t->shards) {
      std::lock_guard<std::mutex> g(sh.mu);
      uint64_t n = sh.keys.size();
      f.write(reinterpret_cast<const char*>(&n), 8);
      f.write(reinterpret_cast<const char*>(sh.keys.data()), n * 8);
      f.write(reinterpret_cast<const char*>(sh.w.data()),
              n * t->dim * sizeof(float));
      f.write(reinterpret_cast<const char*>(sh.state.data()),
              n * t->dim * spd * sizeof(float));
    }
  } else {
    respond_err(fd, "no such table");
    return;
  }
  respond(fd, 0, nullptr, 0);
}

void handle_load(Server& srv, const std::vector<char>& body, uint32_t id,
                 int fd) {
  std::string path(body.begin(), body.end());
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    respond_err(fd, "cannot open " + path);
    return;
  }
  uint8_t kind;
  f.read(reinterpret_cast<char*>(&kind), 1);
  if (kind == 0) {
    DenseTable* t = srv.dense_at(id);
    if (!t) {
      respond_err(fd, "dense table not created");
      return;
    }
    std::lock_guard<std::mutex> g(t->mu);
    f.read(reinterpret_cast<char*>(&t->rows), 8);
    f.read(reinterpret_cast<char*>(&t->dim), 8);
    t->w.resize(t->rows * t->dim);
    t->state.resize(t->rows * t->dim * slots_per_dim(t->opt.kind));
    f.read(reinterpret_cast<char*>(t->w.data()),
           t->w.size() * sizeof(float));
    f.read(reinterpret_cast<char*>(t->state.data()),
           t->state.size() * sizeof(float));
  } else {
    SparseTable* t = srv.sparse_at(id);
    if (!t) {
      respond_err(fd, "sparse table not created");
      return;
    }
    f.read(reinterpret_cast<char*>(&t->dim), 8);
    int spd = slots_per_dim(t->opt.kind);
    for (auto& sh : t->shards) {
      std::lock_guard<std::mutex> g(sh.mu);
      uint64_t n;
      f.read(reinterpret_cast<char*>(&n), 8);
      sh.keys.resize(n);
      f.read(reinterpret_cast<char*>(sh.keys.data()), n * 8);
      sh.w.resize(n * t->dim);
      f.read(reinterpret_cast<char*>(sh.w.data()),
             n * t->dim * sizeof(float));
      sh.state.resize(n * t->dim * spd);
      f.read(reinterpret_cast<char*>(sh.state.data()),
             n * t->dim * spd * sizeof(float));
      sh.index.clear();
      for (uint64_t i = 0; i < n; ++i) sh.index[sh.keys[i]] = i;
    }
  }
  respond(fd, 0, nullptr, 0);
}

void serve_conn(Server& srv, int fd) {
  struct Scope {
    Server& s;
    ~Scope() { s.active_conns.fetch_sub(1); }
  } scope{srv};
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    char hdr[13];
    if (!read_full(fd, hdr, 13)) break;
    uint8_t op = static_cast<uint8_t>(hdr[0]);
    uint32_t table;
    uint64_t nbytes;
    std::memcpy(&table, hdr + 1, 4);
    std::memcpy(&nbytes, hdr + 5, 8);
    if (nbytes > (1ULL << 31)) {      // 2 GiB request cap
      respond_err(fd, "request too large");
      break;
    }
    std::vector<char> body(nbytes);
    if (nbytes && !read_full(fd, body.data(), nbytes)) break;

    switch (op) {
      case kPing:
        respond(fd, 0, "pong", 4);
        break;
      case kCreateTable:
        handle_create(srv, body, table, fd);
        break;
      case kPullDense: {
        DenseTable* t = srv.dense_at(table);
        if (!t) { respond_err(fd, "no dense table"); break; }
        std::lock_guard<std::mutex> g(t->mu);
        respond(fd, 0, t->w.data(), t->w.size() * sizeof(float));
        break;
      }
      case kPushDense:
      case kPushDenseGrad: {
        DenseTable* t = srv.dense_at(table);
        if (!t) { respond_err(fd, "no dense table"); break; }
        std::lock_guard<std::mutex> g(t->mu);
        if (body.size() != t->w.size() * sizeof(float)) {
          respond_err(fd, "dense size mismatch");
          break;
        }
        const float* vals = reinterpret_cast<const float*>(body.data());
        if (op == kPushDense) {
          std::memcpy(t->w.data(), vals, body.size());
        } else {
          t->step += 1;
          uint64_t spd = slots_per_dim(t->opt.kind);
          for (uint64_t r = 0; r < t->rows; ++r)
            apply_row(t->opt, &t->w[r * t->dim],
                      spd ? &t->state[r * t->dim * spd] : nullptr,
                      &vals[r * t->dim], t->dim, t->step);
        }
        respond(fd, 0, nullptr, 0);
        break;
      }
      case kPullSparse: {
        SparseTable* t = srv.sparse_at(table);
        if (!t) { respond_err(fd, "no sparse table"); break; }
        handle_pull_sparse(*t, body, fd);
        break;
      }
      case kAddSparse: {
        SparseTable* t = srv.sparse_at(table);
        if (!t) { respond_err(fd, "no sparse table"); break; }
        handle_add_sparse(*t, body, fd);
        break;
      }
      case kPushSparseGrad:
      case kPushSparse: {
        SparseTable* t = srv.sparse_at(table);
        if (!t) { respond_err(fd, "no sparse table"); break; }
        handle_push_sparse(*t, body, op == kPushSparseGrad, fd);
        break;
      }
      case kSave:
        handle_save(srv, body, table, fd);
        break;
      case kLoad:
        handle_load(srv, body, table, fd);
        break;
      case kStats: {
        uint64_t n = 0;
        if (SparseTable* t = srv.sparse_at(table)) {
          for (auto& sh : t->shards) {
            std::lock_guard<std::mutex> g(sh.mu);
            n += sh.keys.size();
          }
        } else if (DenseTable* t = srv.dense_at(table)) {
          n = t->rows;
        }
        respond(fd, 0, &n, 8);
        break;
      }
      case kKind: {
        uint8_t k = 2;                 // absent
        if (srv.dense_at(table)) k = 0;
        else if (srv.sparse_at(table)) k = 1;
        respond(fd, 0, &k, 1);
        break;
      }
      case kStop:
        respond(fd, 0, nullptr, 0);
        srv.stop.store(true);
        // unblock the accept() loop so the process can exit
        ::shutdown(srv.listen_fd, SHUT_RDWR);
        ::close(fd);
        return;
      default:
        respond_err(fd, "bad op");
    }
    if (srv.stop.load()) break;
  }
  ::close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? std::atoi(argv[1]) : 0;
  const char* host = argc > 2 ? argv[2] : "127.0.0.1";
  int lfd = ::socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    std::fprintf(stderr, "bad bind address %s\n", host);
    return 1;
  }
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
  ::listen(lfd, 64);
  // readiness line consumed by the python launcher
  std::printf("PS_SERVER_READY %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);

  // heap-allocated and never deleted: detached connection threads may
  // still hold the reference at exit; _Exit below skips destructors
  Server& srv = *new Server();
  srv.listen_fd = lfd;
  while (!srv.stop.load()) {
    int cfd = ::accept(lfd, nullptr, nullptr);
    if (cfd < 0) break;
    if (srv.stop.load()) {
      ::close(cfd);
      break;
    }
    srv.active_conns.fetch_add(1);
    // detached: long-lived servers must not accumulate joinable zombies;
    // shutdown waits on the active counter below
    std::thread([&srv, cfd] { serve_conn(srv, cfd); }).detach();
  }
  ::close(lfd);
  for (int i = 0; i < 500 && srv.active_conns.load() > 0; ++i)
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  std::_Exit(0);   // immediate: no destructor races with lingering threads
}
