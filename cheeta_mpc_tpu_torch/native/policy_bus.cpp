// Native transport core: double-buffered topic bus for the MPC/MRT split.
//
// The capability equivalent of the reference's C++ runtime transport
// (reference: ocs2_mpc/src/MRT_BASE.cpp:156-210 double-buffered policy
// handoff under mutex with try-lock swap; ocs2_ros_interfaces
// MPC_ROS_Interface.cpp:183-210 publisher worker thread + condition
// variable; MRT_ROS_Interface.cpp:233-235 custom callback queue draining
// exactly one message per tick). ROS pub/sub is replaced by an in-process
// seqlock topic bus: writers serialize per topic and flip a double buffer;
// readers are wait-free (retry on a torn read), and a condition variable
// supports blocking waits for fresh data (the MRT handshake and reset
// service).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 policy_bus.cpp -o libpolicybus.so
// Exposed to Python via ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Topic {
  std::mutex write_m;                // serializes publishers of this topic
  std::atomic<uint64_t> seq{0};      // number of messages published
  std::atomic<uint32_t> active{0};   // readable buffer index
  std::vector<uint8_t> buf[2];
  std::atomic<uint32_t> len[2];
  std::mutex cv_m;
  std::condition_variable cv;

  Topic() {
    len[0].store(0);
    len[1].store(0);
  }
};

struct Bus {
  int n;
  Topic* topics;
  explicit Bus(int n_topics) : n(n_topics), topics(new Topic[n_topics]) {}
  ~Bus() { delete[] topics; }
};

}  // namespace

extern "C" {

void* bus_create(int n_topics) {
  if (n_topics <= 0) return nullptr;
  return new Bus(n_topics);
}

void bus_destroy(void* handle) { delete static_cast<Bus*>(handle); }

// Publish one message; returns the new sequence number (>= 1), or -1 on a
// bad topic id.
int64_t bus_publish(void* handle, int topic, const uint8_t* data,
                    uint32_t length) {
  Bus* bus = static_cast<Bus*>(handle);
  if (!bus || topic < 0 || topic >= bus->n) return -1;
  Topic& t = bus->topics[topic];
  std::lock_guard<std::mutex> lock(t.write_m);
  const uint32_t back = 1u - t.active.load(std::memory_order_relaxed);
  if (t.buf[back].size() < length) t.buf[back].resize(length);
  std::memcpy(t.buf[back].data(), data, length);
  t.len[back].store(length, std::memory_order_relaxed);
  t.active.store(back, std::memory_order_release);
  const uint64_t s = t.seq.fetch_add(1, std::memory_order_acq_rel) + 1;
  {
    std::lock_guard<std::mutex> cv_lock(t.cv_m);
  }
  t.cv.notify_all();
  return static_cast<int64_t>(s);
}

// Read the latest message. Returns its sequence number (0 if none yet,
// -1 on error); *out_len receives the payload size (up to cap bytes are
// copied). Wait-free for readers: retries if a publisher flipped the
// buffers mid-copy (torn read detection via the seq counter).
int64_t bus_consume(void* handle, int topic, uint8_t* out, uint32_t cap,
                    uint32_t* out_len) {
  Bus* bus = static_cast<Bus*>(handle);
  if (!bus || topic < 0 || topic >= bus->n) return -1;
  Topic& t = bus->topics[topic];
  for (int attempt = 0; attempt < 64; ++attempt) {
    const uint64_t s0 = t.seq.load(std::memory_order_acquire);
    if (s0 == 0) {
      *out_len = 0;
      return 0;
    }
    const uint32_t idx = t.active.load(std::memory_order_acquire);
    const uint32_t n = t.len[idx].load(std::memory_order_relaxed);
    const uint32_t m = n < cap ? n : cap;
    std::memcpy(out, t.buf[idx].data(), m);
    const uint64_t s1 = t.seq.load(std::memory_order_acquire);
    if (s0 == s1) {
      *out_len = n;
      return static_cast<int64_t>(s1);
    }
    // A publish landed mid-read; retry (the new active buffer is stable).
  }
  // Contention beyond bounds: fall back to a locked read.
  std::lock_guard<std::mutex> lock(t.write_m);
  const uint32_t idx = t.active.load(std::memory_order_acquire);
  const uint32_t n = t.len[idx].load(std::memory_order_relaxed);
  const uint32_t m = n < cap ? n : cap;
  std::memcpy(out, t.buf[idx].data(), m);
  *out_len = n;
  return static_cast<int64_t>(t.seq.load(std::memory_order_acquire));
}

// Block until seq > last_seq or timeout; returns current seq (which may be
// <= last_seq on timeout), or -1 on error.
int64_t bus_wait(void* handle, int topic, uint64_t last_seq,
                 int timeout_ms) {
  Bus* bus = static_cast<Bus*>(handle);
  if (!bus || topic < 0 || topic >= bus->n) return -1;
  Topic& t = bus->topics[topic];
  std::unique_lock<std::mutex> lock(t.cv_m);
  t.cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), [&] {
    return t.seq.load(std::memory_order_acquire) > last_seq;
  });
  return static_cast<int64_t>(t.seq.load(std::memory_order_acquire));
}

uint64_t bus_seq(void* handle, int topic) {
  Bus* bus = static_cast<Bus*>(handle);
  if (!bus || topic < 0 || topic >= bus->n) return 0;
  return bus->topics[topic].seq.load(std::memory_order_acquire);
}

}  // extern "C"
