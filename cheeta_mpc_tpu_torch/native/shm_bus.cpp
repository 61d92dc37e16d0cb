// Cross-process shared-memory topic bus (POSIX shm + futex).
//
// The process-split transport of the reference — MPC planning node and MRT
// tracking node as SEPARATE PROCESSES exchanging observation/policy/reset
// messages over ROS TCP/UDP topics (reference:
// ocs2_ros_interfaces/src/mpc/MPC_ROS_Interface.cpp:330-352 launchNodes,
// src/mrt/MRT_ROS_Interface.cpp:246-281, float32 wire readPolicyMsg:125-185)
// — re-done as a lock-free shared-memory seqlock bus: single mmap'd segment,
// per-topic double buffers with per-buffer version counters (torn-read
// detection), writer spinlock, and Linux futexes for cross-process blocking
// waits (the ROS service/handshake role). Latency is two memcpys, no
// serialization stack and no kernel round-trip on the fast path.
//
// Memory layout (64-byte aligned):
//   [Header 4096B: magic u64 | n_topics u32 | cap u32]
//   n_topics x topic blocks, each:
//     [seq u64 | wlock u32 | active u32 | wseq[2] u32 | len[2] u32 |
//      futex u32 | pad -> 64B] [buf0 cap bytes] [buf1 cap bytes]
//     (block size rounded up to 4096)
//
// Publish protocol:   lock; back=1-active; wseq[back]++ (odd = writing);
//                     memcpy; len; wseq[back]++ (even); active=back; seq++;
//                     futex++; FUTEX_WAKE; unlock.
// Consume protocol:   s0=seq; idx=active; v0=wseq[idx] (retry if odd);
//                     memcpy; v1=wseq[idx]; accept iff v0==v1.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 shm_bus.cpp -o libshmbus.so -lrt
// Exposed to Python via ctypes (no pybind11 in the image).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0xC4EE7A6B05000003ull;
constexpr size_t kHeader = 4096;
constexpr size_t kTopicMeta = 64;

struct Header {
  uint64_t magic;
  uint32_t n_topics;
  uint32_t cap;
};

struct TopicMeta {
  uint64_t seq;
  uint32_t wlock;
  uint32_t active;
  uint32_t wseq[2];
  uint32_t len[2];
  uint32_t futex_word;
};

struct Handle {
  void* base;
  size_t size;
  uint32_t n;
  uint32_t cap;
  size_t stride;
};

inline size_t round_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

inline size_t topic_stride(uint32_t cap) {
  return round_up(kTopicMeta + 2ull * cap, 4096);
}

inline TopicMeta* topic_at(const Handle* h, int i) {
  return reinterpret_cast<TopicMeta*>(
      static_cast<uint8_t*>(h->base) + kHeader + h->stride * i);
}

inline uint8_t* buf_at(const Handle* h, int i, int which) {
  return reinterpret_cast<uint8_t*>(topic_at(h, i)) + kTopicMeta +
         static_cast<size_t>(which) * h->cap;
}

inline int futex(uint32_t* addr, int op, uint32_t val,
                 const timespec* timeout) {
  // No FUTEX_PRIVATE_FLAG: the word lives in a shared mapping and must be
  // visible across processes.
  return static_cast<int>(
      syscall(SYS_futex, addr, op, val, timeout, nullptr, 0));
}

Handle* map_segment(int fd, size_t size) {
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  Header* hd = static_cast<Header*>(base);
  Handle* h = new Handle;
  h->base = base;
  h->size = size;
  h->n = hd->n_topics;
  h->cap = hd->cap;
  h->stride = topic_stride(hd->cap);
  return h;
}

}  // namespace

extern "C" {

// Create (or re-create) the named segment. Returns an opaque handle.
void* shm_bus_create(const char* name, int n_topics, uint32_t cap) {
  if (n_topics <= 0 || cap == 0) return nullptr;
  shm_unlink(name);  // fresh segment; stale readers keep their old mapping
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  const size_t size =
      kHeader + topic_stride(cap) * static_cast<size_t>(n_topics);
  if (ftruncate(fd, static_cast<off_t>(size)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  std::memset(base, 0, size);
  Header* hd = static_cast<Header*>(base);
  hd->n_topics = static_cast<uint32_t>(n_topics);
  hd->cap = cap;
  __atomic_store_n(&hd->magic, kMagic, __ATOMIC_RELEASE);
  Handle* h = new Handle;
  h->base = base;
  h->size = size;
  h->n = static_cast<uint32_t>(n_topics);
  h->cap = cap;
  h->stride = topic_stride(cap);
  return h;
}

// Attach to an existing segment; returns nullptr if absent or not yet
// initialized (callers poll + retry during startup).
void* shm_bus_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(kHeader)) {
    close(fd);
    return nullptr;
  }
  // Peek the header first to validate magic before the full mapping.
  void* peek = mmap(nullptr, kHeader, PROT_READ, MAP_SHARED, fd, 0);
  if (peek == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  const Header* hd = static_cast<const Header*>(peek);
  const bool ok = __atomic_load_n(&hd->magic, __ATOMIC_ACQUIRE) == kMagic;
  const uint32_t n = hd->n_topics;
  const uint32_t cap = hd->cap;
  munmap(peek, kHeader);
  const size_t want = kHeader + topic_stride(cap) * static_cast<size_t>(n);
  if (!ok || st.st_size < static_cast<off_t>(want)) {
    close(fd);
    return nullptr;
  }
  return map_segment(fd, want);
}

void shm_bus_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h) return;
  munmap(h->base, h->size);
  delete h;
}

int shm_bus_unlink(const char* name) { return shm_unlink(name); }

int shm_bus_ntopics(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return h ? static_cast<int>(h->n) : -1;
}

uint32_t shm_bus_capacity(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return h ? h->cap : 0;
}

int64_t shm_bus_publish(void* handle, int topic, const uint8_t* data,
                        uint32_t length) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || topic < 0 || topic >= static_cast<int>(h->n) || length > h->cap)
    return -1;
  TopicMeta* t = topic_at(h, topic);
  // Writer spinlock (publishers of one topic serialize; the usage pattern
  // is single-writer-per-topic, so this is uncontended).
  uint32_t expected = 0;
  while (!__atomic_compare_exchange_n(&t->wlock, &expected, 1u, false,
                                      __ATOMIC_ACQUIRE, __ATOMIC_RELAXED)) {
    expected = 0;
  }
  const uint32_t back = 1u - __atomic_load_n(&t->active, __ATOMIC_RELAXED);
  __atomic_add_fetch(&t->wseq[back], 1u, __ATOMIC_RELEASE);  // odd: writing
  std::memcpy(buf_at(h, topic, static_cast<int>(back)), data, length);
  t->len[back] = length;
  __atomic_add_fetch(&t->wseq[back], 1u, __ATOMIC_RELEASE);  // even: stable
  __atomic_store_n(&t->active, back, __ATOMIC_RELEASE);
  const uint64_t s = __atomic_add_fetch(&t->seq, 1ull, __ATOMIC_ACQ_REL);
  __atomic_add_fetch(&t->futex_word, 1u, __ATOMIC_RELEASE);
  futex(&t->futex_word, FUTEX_WAKE, INT32_MAX, nullptr);
  __atomic_store_n(&t->wlock, 0u, __ATOMIC_RELEASE);
  return static_cast<int64_t>(s);
}

int64_t shm_bus_consume(void* handle, int topic, uint8_t* out, uint32_t cap,
                        uint32_t* out_len) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || topic < 0 || topic >= static_cast<int>(h->n)) return -1;
  TopicMeta* t = topic_at(h, topic);
  for (int attempt = 0; attempt < (1 << 16); ++attempt) {
    const uint64_t s0 = __atomic_load_n(&t->seq, __ATOMIC_ACQUIRE);
    if (s0 == 0) {
      *out_len = 0;
      return 0;
    }
    const uint32_t idx = __atomic_load_n(&t->active, __ATOMIC_ACQUIRE);
    const uint32_t v0 = __atomic_load_n(&t->wseq[idx], __ATOMIC_ACQUIRE);
    if (v0 & 1u) continue;  // writer mid-copy on this buffer
    const uint32_t n = t->len[idx];
    const uint32_t m = n < cap ? n : cap;
    std::memcpy(out, buf_at(h, topic, static_cast<int>(idx)), m);
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    const uint32_t v1 = __atomic_load_n(&t->wseq[idx], __ATOMIC_ACQUIRE);
    if (v0 == v1) {
      *out_len = n;
      return static_cast<int64_t>(s0);
    }
    // The buffer was overwritten mid-read (two publishes landed); retry.
  }
  // Pathological contention (or a writer died mid-publish): serialize with
  // publishers via the writer lock for one consistent read.
  uint32_t expected = 0;
  while (!__atomic_compare_exchange_n(&t->wlock, &expected, 1u, false,
                                      __ATOMIC_ACQUIRE, __ATOMIC_RELAXED)) {
    expected = 0;
  }
  const uint32_t idx = __atomic_load_n(&t->active, __ATOMIC_ACQUIRE);
  const uint32_t n = t->len[idx];
  const uint32_t m = n < cap ? n : cap;
  std::memcpy(out, buf_at(h, topic, static_cast<int>(idx)), m);
  const int64_t s =
      static_cast<int64_t>(__atomic_load_n(&t->seq, __ATOMIC_ACQUIRE));
  __atomic_store_n(&t->wlock, 0u, __ATOMIC_RELEASE);
  *out_len = n;
  return s;
}

// Block until seq > last_seq or timeout; returns the current seq (which may
// be <= last_seq on timeout), or -1 on error.
int64_t shm_bus_wait(void* handle, int topic, uint64_t last_seq,
                     int timeout_ms) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || topic < 0 || topic >= static_cast<int>(h->n)) return -1;
  TopicMeta* t = topic_at(h, topic);
  timespec deadline;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  deadline.tv_sec += timeout_ms / 1000;
  deadline.tv_nsec += static_cast<long>(timeout_ms % 1000) * 1000000L;
  if (deadline.tv_nsec >= 1000000000L) {
    deadline.tv_sec += 1;
    deadline.tv_nsec -= 1000000000L;
  }
  for (;;) {
    const uint64_t s = __atomic_load_n(&t->seq, __ATOMIC_ACQUIRE);
    if (s > last_seq) return static_cast<int64_t>(s);
    const uint32_t f = __atomic_load_n(&t->futex_word, __ATOMIC_ACQUIRE);
    // Re-check after reading the futex word (publish bumps futex AFTER seq,
    // so a stale f here would miss the wake otherwise).
    if (__atomic_load_n(&t->seq, __ATOMIC_ACQUIRE) > last_seq)
      return static_cast<int64_t>(
          __atomic_load_n(&t->seq, __ATOMIC_ACQUIRE));
    timespec now, rel;
    clock_gettime(CLOCK_MONOTONIC, &now);
    rel.tv_sec = deadline.tv_sec - now.tv_sec;
    rel.tv_nsec = deadline.tv_nsec - now.tv_nsec;
    if (rel.tv_nsec < 0) {
      rel.tv_sec -= 1;
      rel.tv_nsec += 1000000000L;
    }
    if (rel.tv_sec < 0)
      return static_cast<int64_t>(__atomic_load_n(&t->seq, __ATOMIC_ACQUIRE));
    const int rc = futex(&t->futex_word, FUTEX_WAIT, f, &rel);
    if (rc != 0 && errno != EAGAIN && errno != EINTR && errno != ETIMEDOUT)
      return -1;
  }
}

uint64_t shm_bus_seq(void* handle, int topic) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h || topic < 0 || topic >= static_cast<int>(h->n)) return 0;
  return __atomic_load_n(&topic_at(h, topic)->seq, __ATOMIC_ACQUIRE);
}

}  // extern "C"
