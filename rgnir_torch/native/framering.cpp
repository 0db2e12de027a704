// Zero-copy SPSC shared-memory frame ring for streaming ingestion.
//
// The reference processes files one at a time from disk
// (backend-process.py); a production UAV deployment receives frames
// from a camera/telemetry process. This ring lets a producer process
// publish fixed-size frames into POSIX shared memory and the analyzer
// process consume them lock-free (single-producer single-consumer,
// acquire/release atomics, no syscalls on the hot path).
//
// A copy of the JAX package's framering.cpp with the same header layout,
// so a ring created by either package opens in the other. C ABI, bound
// with ctypes by rgnir_torch.native.ring:
//   fr_create(name, frame_bytes, capacity) -> handle | NULL
//   fr_open(name)                          -> handle | NULL
//   fr_try_push(h, src)  -> 1 pushed, 0 full
//   fr_try_pop(h, dst)   -> 1 popped, 0 empty
//   fr_finish(h) / fr_eof(h) -> producer end-of-stream flag
//   fr_size(h) / fr_capacity(h) / fr_frame_bytes(h)
//   fr_close(h, unlink)
//
// Layout: [Header | capacity * frame_bytes], header cacheline-padded.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <new>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct alignas(64) Header {
  uint64_t magic;
  uint64_t frame_bytes;
  uint64_t capacity;
  std::atomic<uint64_t> eof;               // producer finished (no more pushes)
  alignas(64) std::atomic<uint64_t> head;  // next write position
  alignas(64) std::atomic<uint64_t> tail;  // next read position
};

constexpr uint64_t kMagic = 0x52474E4952494E47ull;  // "RGNIRING"

struct Handle {
  Header* hdr;
  uint8_t* slots;
  size_t map_bytes;
  char name[256];
};

size_t total_bytes(uint64_t frame_bytes, uint64_t capacity) {
  return sizeof(Header) + frame_bytes * capacity;
}

}  // namespace

extern "C" {

void* fr_create(const char* name, uint64_t frame_bytes, uint64_t capacity) {
  if (frame_bytes == 0 || capacity == 0) return nullptr;
  shm_unlink(name);  // fresh ring
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = total_bytes(frame_bytes, capacity);
  if (ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* hdr = new (mem) Header();
  hdr->magic = kMagic;
  hdr->frame_bytes = frame_bytes;
  hdr->capacity = capacity;
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->eof.store(0, std::memory_order_relaxed);
  Handle* h = new Handle();
  h->hdr = hdr;
  h->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_bytes = bytes;
  strncpy(h->name, name, sizeof(h->name) - 1);
  h->name[sizeof(h->name) - 1] = '\0';
  return h;
}

void* fr_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* hdr = reinterpret_cast<Header*>(mem);
  if (hdr->magic != kMagic ||
      total_bytes(hdr->frame_bytes, hdr->capacity) != (size_t)st.st_size) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  Handle* h = new Handle();
  h->hdr = hdr;
  h->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(Header);
  h->map_bytes = st.st_size;
  strncpy(h->name, name, sizeof(h->name) - 1);
  h->name[sizeof(h->name) - 1] = '\0';
  return h;
}

int fr_try_push(void* handle, const uint8_t* src) {
  Handle* h = static_cast<Handle*>(handle);
  Header* r = h->hdr;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;  // full
  uint64_t slot = head % r->capacity;
  memcpy(h->slots + slot * r->frame_bytes, src, r->frame_bytes);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

int fr_try_pop(void* handle, uint8_t* dst) {
  Handle* h = static_cast<Handle*>(handle);
  Header* r = h->hdr;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return 0;  // empty
  uint64_t slot = tail % r->capacity;
  memcpy(dst, h->slots + slot * r->frame_bytes, r->frame_bytes);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

// Producer end-of-stream. Contract: call AFTER the final fr_try_push;
// the release store orders it after every prior push, so a consumer
// that observes eof (acquire) and then finds the ring empty has seen
// every frame.
void fr_finish(void* handle) {
  static_cast<Handle*>(handle)->hdr->eof.store(1, std::memory_order_release);
}

int fr_eof(void* handle) {
  return (int)static_cast<Handle*>(handle)->hdr->eof.load(
      std::memory_order_acquire);
}

uint64_t fr_size(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  return h->hdr->head.load(std::memory_order_acquire) -
         h->hdr->tail.load(std::memory_order_acquire);
}

uint64_t fr_capacity(void* handle) {
  return static_cast<Handle*>(handle)->hdr->capacity;
}

uint64_t fr_frame_bytes(void* handle) {
  return static_cast<Handle*>(handle)->hdr->frame_bytes;
}

void fr_close(void* handle, int unlink_shm) {
  Handle* h = static_cast<Handle*>(handle);
  if (unlink_shm) shm_unlink(h->name);
  munmap(h->hdr, h->map_bytes);
  delete h;
}

}  // extern "C"
