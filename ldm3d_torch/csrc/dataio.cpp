// Native reader of the volume cache for the PyTorch port: a C++ thread
// pool that reads cached .npy volumes (float16 payload) into batch
// buffers, raw or widened to float32, without holding the Python GIL, so
// host IO overlaps device compute. The port's copy of the JAX package's
// reader; bound with ctypes by ldm3d_torch/data/native.py, which builds it
// with g++ at first use into ldm3d_torch/_build/.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---- float16 -> float32 (scalar, branchless-ish) --------------------------
static inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;  // +-0
    } else {        // subnormal: normalize (effective exponent 1-15-shift)
      int shift = 0;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        ++shift;
      }
      mant &= 0x3FFu;
      bits = sign | ((uint32_t)(127 - 14 - shift) << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

struct Job {
  std::function<void()> fn;
};

struct Pool {
  std::vector<std::thread> workers;
  std::queue<Job> jobs;
  std::mutex mu;
  std::condition_variable cv_job;
  std::condition_variable cv_done;
  std::atomic<int64_t> pending{0};
  std::atomic<int64_t> errors{0};
  bool stop = false;

  explicit Pool(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_job.notify_all();
    for (auto& t : workers) t.join();
  }

  void submit(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.push(Job{std::move(fn)});
      pending.fetch_add(1);
    }
    cv_job.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [this] { return pending.load() == 0; });
  }

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [this] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = std::move(jobs.front());
        jobs.pop();
      }
      job.fn();
      if (pending.fetch_sub(1) == 1) cv_done.notify_all();
    }
  }
};

// Read `n_elems` float16 values at `offset` from `path`, widening into
// `dst` as float32. Returns 0 on success.
static int read_f16_as_f32(const char* path, int64_t offset, float* dst,
                           int64_t n_elems) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  if (std::fseek(f, (long)offset, SEEK_SET) != 0) {
    std::fclose(f);
    return 2;
  }
  constexpr int64_t kChunk = 1 << 16;  // 64k halves per read
  std::vector<uint16_t> buf(kChunk);
  int64_t done = 0;
  while (done < n_elems) {
    int64_t want = std::min(kChunk, n_elems - done);
    size_t got = std::fread(buf.data(), sizeof(uint16_t), (size_t)want, f);
    if ((int64_t)got != want) {
      std::fclose(f);
      return 3;
    }
    for (int64_t i = 0; i < want; ++i) dst[done + i] = half_to_float(buf[i]);
    done += want;
  }
  std::fclose(f);
  return 0;
}

// Read `n_bytes` raw bytes at `offset` from `path` into `dst` (used for
// the f16-transfer loader path: no widening, payload ships to the device
// as-is). Returns 0 on success.
static int read_raw(const char* path, int64_t offset, uint8_t* dst,
                    int64_t n_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  if (std::fseek(f, (long)offset, SEEK_SET) != 0) {
    std::fclose(f);
    return 2;
  }
  size_t got = std::fread(dst, 1, (size_t)n_bytes, f);
  std::fclose(f);
  return (int64_t)got == n_bytes ? 0 : 3;
}

}  // namespace

extern "C" {

void* ldm3d_pool_create(int n_threads) { return new Pool(n_threads); }

void ldm3d_pool_destroy(void* pool) { delete static_cast<Pool*>(pool); }

// Async: read the float16 payload of `path` at `offset` into `dst` as f32.
void ldm3d_pool_submit_f16(void* pool, const char* path, int64_t offset,
                           float* dst, int64_t n_elems) {
  auto* p = static_cast<Pool*>(pool);
  std::string path_copy(path);
  p->submit([p, path_copy, offset, dst, n_elems] {
    if (read_f16_as_f32(path_copy.c_str(), offset, dst, n_elems) != 0) {
      p->errors.fetch_add(1);
    }
  });
}

// Block until every submitted job completed. Returns the number of jobs
// that failed since the last wait (and resets the counter).
int64_t ldm3d_pool_wait(void* pool) {
  auto* p = static_cast<Pool*>(pool);
  p->wait();
  return p->errors.exchange(0);
}

// Synchronous single read, for the simple VolumeCache.read path.
int ldm3d_read_f16_as_f32(const char* path, int64_t offset, float* dst,
                          int64_t n_elems) {
  return read_f16_as_f32(path, offset, dst, n_elems);
}

// Async raw read (no widening) — parallel file IO for the f16-transfer
// loader path where the payload ships to the device at cache precision.
void ldm3d_pool_submit_raw(void* pool, const char* path, int64_t offset,
                           uint8_t* dst, int64_t n_bytes) {
  auto* p = static_cast<Pool*>(pool);
  std::string path_copy(path);
  p->submit([p, path_copy, offset, dst, n_bytes] {
    if (read_raw(path_copy.c_str(), offset, dst, n_bytes) != 0) {
      p->errors.fetch_add(1);
    }
  });
}

}  // extern "C"
