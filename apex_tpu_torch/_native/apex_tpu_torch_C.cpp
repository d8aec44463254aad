// apex_tpu_torch_C: the host runtime of the input pipeline.
//
// A copy of apex_tpu/_native/apex_tpu_C.cpp without its flatten, unflatten
// and bucket-planning entries (the port's DDP packs grads with torch.cat):
// the threaded uint8 -> fp32 normalize of a batch, NCHW or NHWC, and the
// prefetching loader's ring of batch slots filled by worker threads.
//
// A plain C ABI with no dependencies beyond the C++17 standard library,
// built with g++ by apex_tpu_torch/_native/__init__.py and loaded with
// ctypes; the Python side keeps a numpy fallback for every entry.

#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <numeric>
#include <queue>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal thread pool (the one-shot preprocessing).
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
          done_.fetch_add(1, std::memory_order_release);
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  void Submit(std::function<void()> f) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(f));
    }
    submitted_.fetch_add(1, std::memory_order_acq_rel);
    cv_.notify_one();
  }

  // Monotonic counters, never reset: Wait() snapshots the submit count at
  // entry and blocks until that many tasks have completed.  Concurrent
  // callers sharing the singleton pool may over-wait (for each other's
  // tasks) but can never under-wait or deadlock — no data race.
  void Wait() {
    uint64_t target = submitted_.load(std::memory_order_acquire);
    while (done_.load(std::memory_order_acquire) < target) {
      std::this_thread::yield();
    }
  }

  static ThreadPool& Get() {
    static ThreadPool pool(
        std::max(1u, std::thread::hardware_concurrency()));
    return pool;
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
  std::atomic<uint64_t> submitted_{0};
  std::atomic<uint64_t> done_{0};
};

}  // namespace

namespace {

// Shared per-image normalize: uint8 HWC plane gather -> fp32 CHW planes.
// Used by the one-shot preprocess API and the prefetching loader.
inline void NormalizeImage(const uint8_t* src, float* dst, int64_t h,
                           int64_t w, int64_t c, const float* mean,
                           const float* inv_std) {
  for (int64_t k = 0; k < c; ++k) {
    float mk = mean[k], ik = inv_std[k];
    float* plane = dst + k * h * w;
    for (int64_t p = 0; p < h * w; ++p) {
      plane[p] = (static_cast<float>(src[p * c + k]) - mk) * ik;
    }
  }
}

// channels-last variant: normalize in place order (no transpose) — a
// straight sequential walk, feeding channels-last models without the
// NHWC->NCHW->NHWC round trip.
inline void NormalizeImageNHWC(const uint8_t* src, float* dst, int64_t h,
                               int64_t w, int64_t c, const float* mean,
                               const float* inv_std) {
  for (int64_t p = 0; p < h * w; ++p) {
    const uint8_t* sp = src + p * c;
    float* dp = dst + p * c;
    for (int64_t k = 0; k < c; ++k) {
      dp[k] = (static_cast<float>(sp[k]) - mean[k]) * inv_std[k];
    }
  }
}

}  // namespace

extern "C" {

// Input-pipeline preprocessing: NHWC uint8 images -> NCHW float32,
// normalized with per-channel mean/std — the host half of the reference
// example's data_prefetcher (examples/imagenet/main_amp.py:264-300), here
// on host threads overlapped with device compute.
static void PreprocessBatch(const uint8_t* in, float* out, int64_t n,
                            int64_t h, int64_t w, int64_t c,
                            const float* mean, const float* std,
                            bool channels_last) {
  auto& pool = ThreadPool::Get();
  std::vector<float> inv_std(c);
  for (int64_t k = 0; k < c; ++k) inv_std[k] = 1.0f / std[k];
  const float* inv = inv_std.data();
  for (int64_t img = 0; img < n; ++img) {
    const uint8_t* src = in + img * h * w * c;
    float* dst = out + img * h * w * c;   // same element count per image
    pool.Submit([src, dst, h, w, c, mean, inv, channels_last] {
      if (channels_last) {
        NormalizeImageNHWC(src, dst, h, w, c, mean, inv);
      } else {
        NormalizeImage(src, dst, h, w, c, mean, inv);
      }
    });
  }
  pool.Wait();
}

void apex_preprocess_nhwc_u8_to_nchw_f32(const uint8_t* in, float* out,
                                         int64_t n, int64_t h, int64_t w,
                                         int64_t c, const float* mean,
                                         const float* std) {
  PreprocessBatch(in, out, n, h, w, c, mean, std, /*channels_last=*/false);
}

// channels-last variant: same threaded normalize, no transpose
void apex_preprocess_nhwc_u8_to_nhwc_f32(const uint8_t* in, float* out,
                                         int64_t n, int64_t h, int64_t w,
                                         int64_t c, const float* mean,
                                         const float* std) {
  PreprocessBatch(in, out, n, h, w, c, mean, std, /*channels_last=*/true);
}

int apex_native_version() { return 3; }

// Concatenate n same-dtype host tensors into one contiguous buffer
// (apex_C.flatten). srcs[i] points at sizes[i] elements of elem_size bytes.
void apex_flatten(const void** srcs, const int64_t* sizes, int n,
                  int64_t elem_size, void* dst) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + sizes[i];
  auto& pool = ThreadPool::Get();
  char* out = static_cast<char*>(dst);
  for (int i = 0; i < n; ++i) {
    const char* src = static_cast<const char*>(srcs[i]);
    char* d = out + offsets[i] * elem_size;
    int64_t bytes = sizes[i] * elem_size;
    pool.Submit([src, d, bytes] { std::memcpy(d, src, bytes); });
  }
  pool.Wait();
}

// Inverse: scatter a flat buffer back into n host tensors
// (apex_C.unflatten).
void apex_unflatten(const void* src, const int64_t* sizes, int n,
                    int64_t elem_size, void** dsts) {
  std::vector<int64_t> offsets(n + 1, 0);
  for (int i = 0; i < n; ++i) offsets[i + 1] = offsets[i] + sizes[i];
  auto& pool = ThreadPool::Get();
  const char* in = static_cast<const char*>(src);
  for (int i = 0; i < n; ++i) {
    const char* s = in + offsets[i] * elem_size;
    char* dst = static_cast<char*>(dsts[i]);
    int64_t bytes = sizes[i] * elem_size;
    pool.Submit([s, dst, bytes] { std::memcpy(dst, s, bytes); });
  }
  pool.Wait();
}

// Greedy in-order bucket assignment: tensors are packed into buckets of at
// least message_size elements in arrival order (the planning half of the
// reference DDP's bucketing).  Returns the number of buckets.
int apex_plan_buckets(const int64_t* sizes, int n, int64_t message_size,
                      int32_t* bucket_ids) {
  int bucket = 0;
  int64_t filled = 0;
  for (int i = 0; i < n; ++i) {
    bucket_ids[i] = bucket;
    filled += sizes[i];
    if (filled >= message_size) {
      bucket++;
      filled = 0;
    }
  }
  return (filled > 0 || n == 0) ? bucket + 1 : bucket;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefetching data loader: the native input pipeline.
//
// The reference's data_prefetcher (examples/imagenet/main_amp.py:264-300)
// overlaps H2D copies + normalization with compute on a side CUDA stream.
// Here the host side is native: worker threads assemble normalized fp32
// batches (NCHW or NHWC) into a ring of slots *ahead* of the training
// loop, so the Python step only wraps a ready pointer and copies it to the
// device while the next batches are already being built.
//
// Ordered delivery: batch numbers are assigned under the slot mutex, so
// the outstanding batches always occupy the available slots and the
// consumer (who demands batch k before k+1) can never deadlock.
// Shuffling is a per-epoch affine bijection i -> (a*i + c) % n (stateless,
// workers never coordinate about epoch boundaries).
// ---------------------------------------------------------------------------

namespace {

struct Slot {
  std::vector<float> images;
  std::vector<int32_t> labels;
  int64_t batch = -1;
  enum State { kFree, kFilling, kReady, kInUse } state = kFree;
};

struct Loader {
  const uint8_t* images;  // (n, h, w, c) borrowed; caller keeps it alive
  const int32_t* labels;  // (n,)
  int64_t n, h, w, c, batch;
  std::vector<float> mean, inv_std;
  bool channels_last = false;   // deliver (B, H, W, C) instead of NCHW
  bool shuffle;
  uint64_t seed;
  int64_t batches_per_epoch;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  int64_t next_fill = 0;
  int64_t next_deliver = 0;
  bool stop = false;
  // consumers currently inside apex_loader_next: destroy() must not free
  // the Loader while one is re-acquiring mu after the stop wakeup
  int in_next = 0;
  std::condition_variable cv_quiesce;

  // Per-epoch true permutations (Fisher–Yates over a splitmix64 stream),
  // matching the Python fallback's np.random.permutation semantics: every
  // sample appears exactly once per epoch.  The previous affine-bijection
  // "shuffle" was a correlated-stride walk, not a uniform shuffle
  // (round-1 advisor finding).  Four exact-keyed cache slots cover the
  // epochs that can be in flight at once (bounded by prefetch depth);
  // Fill() copies its batch's indices under one lock, so no reference
  // escapes and workers don't serialize per sample.
  static constexpr int kPermSlots = 4;
  std::mutex perm_mu;
  std::array<int64_t, kPermSlots> perm_epoch{-1, -1, -1, -1};
  std::array<std::vector<int64_t>, kPermSlots> perms;

  static uint64_t SplitMix64(uint64_t& s) {
    uint64_t z = (s += 0x9e3779b97f4a7c15ull);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }

  // Copies the batch's sample indices out *by value under one lock*: a
  // reference escaping the lock could be regenerated in place by a worker
  // several epochs ahead reusing the cache slot (tiny datasets put 3+
  // epochs in flight with the default prefetch depth).
  void BatchIndices(int64_t global_batch, std::vector<int64_t>& out) {
    int64_t epoch = global_batch / batches_per_epoch;
    int64_t start = (global_batch % batches_per_epoch) * batch;
    out.resize(batch);
    if (!shuffle) {
      for (int64_t j = 0; j < batch; ++j) out[j] = start + j;
      return;
    }
    std::lock_guard<std::mutex> lock(perm_mu);
    int slot = static_cast<int>(epoch % kPermSlots);
    if (perm_epoch[slot] != epoch) {
      auto& p = perms[slot];
      p.resize(n);
      for (int64_t k = 0; k < n; ++k) p[k] = k;
      uint64_t s = seed + 0x9e3779b97f4a7c15ull * (epoch + 1);
      for (int64_t k = n - 1; k > 0; --k) {
        int64_t j = static_cast<int64_t>(SplitMix64(s) % (k + 1));
        std::swap(p[k], p[j]);
      }
      perm_epoch[slot] = epoch;
    }
    const auto& p = perms[slot];
    for (int64_t j = 0; j < batch; ++j) out[j] = p[start + j];
  }

  void Fill(Slot& s, int64_t b) {
    float* dst_base = s.images.data();
    std::vector<int64_t> idx;
    BatchIndices(b, idx);
    for (int64_t j = 0; j < batch; ++j) {
      int64_t src_idx = idx[j];
      const uint8_t* src = images + src_idx * h * w * c;
      float* dst = dst_base + j * c * h * w;
      if (channels_last) {
        NormalizeImageNHWC(src, dst, h, w, c, mean.data(), inv_std.data());
      } else {
        NormalizeImage(src, dst, h, w, c, mean.data(), inv_std.data());
      }
      s.labels[j] = labels[src_idx];
    }
  }

  void WorkerLoop() {
    for (;;) {
      Slot* s = nullptr;
      int64_t b;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_free.wait(lock, [this] {
          if (stop) return true;
          for (auto& sl : slots)
            if (sl.state == Slot::kFree) return true;
          return false;
        });
        if (stop) return;
        for (auto& sl : slots) {
          if (sl.state == Slot::kFree) { s = &sl; break; }
        }
        b = next_fill++;  // assigned under the lock: see header comment
        s->state = Slot::kFilling;
        s->batch = b;
      }
      Fill(*s, b);
      {
        std::lock_guard<std::mutex> lock(mu);
        s->state = Slot::kReady;
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* apex_loader_create(const uint8_t* images, const int32_t* labels,
                         int64_t n, int64_t h, int64_t w, int64_t c,
                         int64_t batch, int depth, int num_workers,
                         uint64_t seed, const float* mean,
                         const float* stddev, int shuffle,
                         int channels_last) {
  if (n < batch || batch <= 0 || depth <= 0 || num_workers <= 0)
    return nullptr;
  auto* L = new Loader();
  L->images = images;
  L->labels = labels;
  L->n = n; L->h = h; L->w = w; L->c = c; L->batch = batch;
  L->channels_last = channels_last != 0;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->batches_per_epoch = n / batch;  // drop-last
  L->mean.assign(mean, mean + c);
  L->inv_std.resize(c);
  for (int64_t k = 0; k < c; ++k) L->inv_std[k] = 1.0f / stddev[k];
  L->slots.resize(depth);
  for (auto& s : L->slots) {
    s.images.resize(batch * c * h * w);
    s.labels.resize(batch);
  }
  for (int i = 0; i < num_workers; ++i)
    L->workers.emplace_back([L] { L->WorkerLoop(); });
  return L;
}

// Blocks until the next in-order batch is ready; returns its index and
// pointers into the slot (valid until apex_loader_release of that pointer).
int64_t apex_loader_next(void* loader, const float** out_images,
                         const int32_t** out_labels) {
  auto* L = static_cast<Loader*>(loader);
  std::unique_lock<std::mutex> lock(L->mu);
  L->in_next++;
  Slot* hit = nullptr;
  // stop also releases consumers: destroy() must not hang a thread
  // blocked here (round-1 advisor finding)
  L->cv_ready.wait(lock, [&] {
    if (L->stop) return true;
    for (auto& s : L->slots) {
      if (s.state == Slot::kReady && s.batch == L->next_deliver) {
        hit = &s;
        return true;
      }
    }
    return false;
  });
  if (L->stop && hit == nullptr) {
    // signal destroy() we are out before it frees the Loader
    L->in_next--;
    L->cv_quiesce.notify_all();
    return -1;
  }
  L->in_next--;
  L->cv_quiesce.notify_all();   // destroy() may be draining concurrently
  hit->state = Slot::kInUse;
  L->next_deliver++;
  *out_images = hit->images.data();
  *out_labels = hit->labels.data();
  return hit->batch;
}

// Return a delivered slot (identified by its images pointer) to the pool.
void apex_loader_release(void* loader, const float* images_ptr) {
  auto* L = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    for (auto& s : L->slots) {
      if (s.images.data() == images_ptr && s.state == Slot::kInUse) {
        s.state = Slot::kFree;
        break;
      }
    }
  }
  L->cv_free.notify_one();
}

void apex_loader_destroy(void* loader) {
  auto* L = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->stop = true;
  }
  L->cv_free.notify_all();
  L->cv_ready.notify_all();   // wake any consumer blocked in next()
  {
    // wait until no consumer is inside next() — deleting while one is
    // re-acquiring mu after the stop wakeup would be a use-after-free
    std::unique_lock<std::mutex> lock(L->mu);
    L->cv_quiesce.wait(lock, [L] { return L->in_next == 0; });
  }
  for (auto& wkr : L->workers) wkr.join();
  delete L;
}

}  // extern "C"
