// Native blocking queue + shared-memory ring for the data pipeline.
//
// reference parity: paddle/fluid/operators/reader/blocking_queue.h
// (BlockingQueue<T>: bounded Send/Receive with close/kill semantics) and
// the shared-memory batch transport of fluid/dataloader/worker.py:341
// (_array_to_share_memory_tensor + mmap allocator,
// memory/allocation/mmap_allocator.cc).
//
// TPU-native design: the queue carries opaque byte buffers (pickled or raw
// numpy batches). Buffers are copied into C-heap storage on push, so
// producer threads release the GIL immediately and the Python consumer
// side never blocks the producer beyond `capacity` items. A blocking pop
// with timeout backs the DataLoader prefetch thread. Everything is plain
// C ABI for ctypes (no pybind11 in this environment).
//
// Build: g++ -O2 -shared -fPIC -pthread blocking_queue.cpp -o libpq.so

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>

namespace {

struct Buffer {
  uint8_t* data;
  size_t size;
};

class BlockingQueue {
 public:
  explicit BlockingQueue(size_t capacity) : capacity_(capacity) {}

  ~BlockingQueue() {
    Kill();
    std::lock_guard<std::mutex> lock(mu_);
    for (auto& b : q_) delete[] b.data;
    q_.clear();
  }

  // returns 1 on success, 0 if closed/killed
  int Send(const uint8_t* data, size_t size) {
    std::unique_lock<std::mutex> lock(mu_);
    send_cv_.wait(lock,
                  [&] { return q_.size() < capacity_ || closed_ || killed_; });
    if (closed_ || killed_) return 0;
    uint8_t* copy = new (std::nothrow) uint8_t[size];
    if (copy == nullptr) return 0;
    std::memcpy(copy, data, size);
    q_.push_back(Buffer{copy, size});
    recv_cv_.notify_one();
    return 1;
  }

  // returns: 1 ok (out filled), 0 drained-and-closed, -1 timeout, -2 killed
  int Receive(Buffer* out, long timeout_ms) {
    std::unique_lock<std::mutex> lock(mu_);
    auto ready = [&] { return !q_.empty() || closed_ || killed_; };
    if (timeout_ms < 0) {
      recv_cv_.wait(lock, ready);
    } else if (!recv_cv_.wait_for(lock, std::chrono::milliseconds(timeout_ms),
                                  ready)) {
      return -1;
    }
    if (killed_) return -2;
    if (q_.empty()) return 0;  // closed and drained
    *out = q_.front();
    q_.pop_front();
    send_cv_.notify_one();
    return 1;
  }

  void Close() {  // graceful: consumers drain remaining items
    std::lock_guard<std::mutex> lock(mu_);
    closed_ = true;
    send_cv_.notify_all();
    recv_cv_.notify_all();
  }

  void Kill() {  // abrupt: unblock everyone, drop everything
    std::lock_guard<std::mutex> lock(mu_);
    killed_ = true;
    send_cv_.notify_all();
    recv_cv_.notify_all();
  }

  size_t Size() {
    std::lock_guard<std::mutex> lock(mu_);
    return q_.size();
  }

  int Closed() {
    std::lock_guard<std::mutex> lock(mu_);
    return closed_ ? 1 : 0;
  }

 private:
  const size_t capacity_;
  std::deque<Buffer> q_;
  std::mutex mu_;
  std::condition_variable send_cv_, recv_cv_;
  bool closed_ = false;
  bool killed_ = false;
};

}  // namespace

extern "C" {

void* pq_create(size_t capacity) {
  if (capacity == 0) return nullptr;
  return new BlockingQueue(capacity);
}

void pq_destroy(void* q) { delete static_cast<BlockingQueue*>(q); }

int pq_send(void* q, const uint8_t* data, size_t size) {
  return static_cast<BlockingQueue*>(q)->Send(data, size);
}

// On success (*size, return buffer ptr). Caller must pq_free the buffer.
// status: 1 ok, 0 closed+drained, -1 timeout, -2 killed
uint8_t* pq_receive(void* q, size_t* size, long timeout_ms, int* status) {
  Buffer out{nullptr, 0};
  int st = static_cast<BlockingQueue*>(q)->Receive(&out, timeout_ms);
  *status = st;
  if (st != 1) {
    *size = 0;
    return nullptr;
  }
  *size = out.size;
  return out.data;
}

void pq_free(uint8_t* buf) { delete[] buf; }

void pq_close(void* q) { static_cast<BlockingQueue*>(q)->Close(); }
void pq_kill(void* q) { static_cast<BlockingQueue*>(q)->Kill(); }
size_t pq_size(void* q) { return static_cast<BlockingQueue*>(q)->Size(); }
int pq_closed(void* q) { return static_cast<BlockingQueue*>(q)->Closed(); }

}  // extern "C"
