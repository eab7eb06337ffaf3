// Shared-memory SPSC ring buffer: the DataLoader worker->main batch
// transport, native.
//
// Reference analogue: the C++ reader core the reference feeds trainers
// with (paddle/fluid/operators/reader/buffered_reader.cc over
// paddle/fluid/memory shared-memory allocations; the Python DataLoader's
// _shared_memory path serializes into the same kind of segment). Here the
// ring IS the queue: fixed-size slots in one POSIX shm segment, a
// lock-free single-producer/single-consumer head/tail pair with acquire/
// release atomics, and a spin-then-sleep wait so an idle reader costs no
// CPU. One worker process owns the producer side; the main process pops.
//
// Layout: [Header | slot 0 | slot 1 | ... | slot n-1]
//   slot: u64 payload_len | payload bytes (slot_size - 8 capacity)
// C ABI (ctypes-bound in runtime/__init__.py):
//   shm_ring_create(name, slot_size, n_slots) -> handle | NULL
//   shm_ring_attach(name)                     -> handle | NULL
//   shm_ring_push(h, buf, len, timeout_ms)    -> 0 | -1 timeout | -2 big
//   shm_ring_pop(h, out, cap, timeout_ms)     -> len | -1 timeout | -2 cap
//   shm_ring_size(h)                          -> slots currently filled
//   shm_ring_close(h, unlink)

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <string>

namespace {

constexpr uint64_t kMagic = 0x70745F72696E6731ULL;  // "pt_ring1"

struct Header {
  uint64_t magic;
  uint64_t slot_size;   // bytes per slot incl. the u64 length prefix
  uint64_t n_slots;
  std::atomic<uint64_t> head;   // next slot to pop
  std::atomic<uint64_t> tail;   // next slot to push
};

struct Ring {
  Header* hdr;
  uint8_t* data;
  size_t map_len;
  std::string name;
};

uint8_t* slot_ptr(Ring* r, uint64_t idx) {
  return r->data + (idx % r->hdr->n_slots) * r->hdr->slot_size;
}

void sleep_ns(long ns) {
  timespec ts{0, ns};
  nanosleep(&ts, nullptr);
}

// spin briefly, then sleep in escalating steps; returns false on timeout
template <typename Cond>
bool wait_until(Cond cond, int timeout_ms) {
  for (int i = 0; i < 256; ++i) {
    if (cond()) return true;
  }
  long waited_ns = 0;
  long step = 50 * 1000;                       // 50 us
  const long limit = int64_t(timeout_ms) * 1000 * 1000;
  while (timeout_ms < 0 || waited_ns < limit) {
    if (cond()) return true;
    sleep_ns(step);
    waited_ns += step;
    if (step < 2 * 1000 * 1000) step *= 2;     // cap at 2 ms
  }
  return cond();
}

}  // namespace

extern "C" {

void* shm_ring_create(const char* name, uint64_t slot_size,
                      uint32_t n_slots) {
  if (slot_size < 16 || n_slots == 0) return nullptr;
  shm_unlink(name);                            // stale segment from a crash
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t len = sizeof(Header) + size_t(slot_size) * n_slots;
  if (ftruncate(fd, off_t(len)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) Header();
  hdr->slot_size = slot_size;
  hdr->n_slots = n_slots;
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->magic = kMagic;
  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(Header), len,
                     name};
  return r;
}

void* shm_ring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || size_t(st.st_size) < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, size_t(st.st_size), PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<Header*>(mem);
  if (hdr->magic != kMagic) {
    munmap(mem, size_t(st.st_size));
    return nullptr;
  }
  auto* r = new Ring{hdr, static_cast<uint8_t*>(mem) + sizeof(Header),
                     size_t(st.st_size), name};
  return r;
}

int shm_ring_push(void* handle, const void* buf, uint64_t len,
                  int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  if (len + 8 > r->hdr->slot_size) return -2;
  auto full = [r] {
    return r->hdr->tail.load(std::memory_order_relaxed) -
               r->hdr->head.load(std::memory_order_acquire) <
           r->hdr->n_slots;
  };
  if (!wait_until(full, timeout_ms)) return -1;
  uint64_t t = r->hdr->tail.load(std::memory_order_relaxed);
  uint8_t* slot = slot_ptr(r, t);
  std::memcpy(slot, &len, 8);
  std::memcpy(slot + 8, buf, len);
  r->hdr->tail.store(t + 1, std::memory_order_release);
  return 0;
}

int64_t shm_ring_pop(void* handle, void* out, uint64_t cap,
                     int timeout_ms) {
  auto* r = static_cast<Ring*>(handle);
  auto nonempty = [r] {
    return r->hdr->head.load(std::memory_order_relaxed) <
           r->hdr->tail.load(std::memory_order_acquire);
  };
  if (!wait_until(nonempty, timeout_ms)) return -1;
  uint64_t h = r->hdr->head.load(std::memory_order_relaxed);
  uint8_t* slot = slot_ptr(r, h);
  uint64_t len;
  std::memcpy(&len, slot, 8);
  if (len > cap) return -2;
  std::memcpy(out, slot + 8, len);
  r->hdr->head.store(h + 1, std::memory_order_release);
  return int64_t(len);
}

uint64_t shm_ring_slot_size(void* handle) {
  return static_cast<Ring*>(handle)->hdr->slot_size;
}

uint64_t shm_ring_size(void* handle) {
  auto* r = static_cast<Ring*>(handle);
  return r->hdr->tail.load(std::memory_order_acquire) -
         r->hdr->head.load(std::memory_order_acquire);
}

void shm_ring_close(void* handle, int unlink) {
  auto* r = static_cast<Ring*>(handle);
  std::string name = r->name;
  munmap(r->hdr, r->map_len);
  if (unlink) shm_unlink(name.c_str());
  delete r;
}

}  // extern "C"
