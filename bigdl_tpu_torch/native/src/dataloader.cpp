// Native data pipeline, the port's copy of the JAX package's loader: the
// counterpart of the reference's multi-threaded batch building
// (dataset/image/MTLabeledBGRImgToBatch.scala + the MKL-native preprocessing the JVM leaned on).
//
// Provides:
//  - idx (MNIST) and CIFAR-10 binary decoding into float arrays
//  - a multi-threaded augmenting batch loader: random crop + horizontal
//    flip + per-channel normalize, producing NCHW float32 batches into a
//    ring of prefetch buffers while the card computes.
// Exported with C linkage for ctypes.
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------- decoders

// Parse an idx file (MNIST): returns 0 on success; fills dims (up to 4).
// data_out receives float32 values (bytes scaled 1:1, no normalization).
int bigdl_parse_idx(const uint8_t* buf, int64_t len, float* data_out,
                    int64_t out_capacity, int32_t* dims_out,
                    int32_t* ndim_out) {
  if (len < 4) return -1;
  if (buf[0] != 0 || buf[1] != 0) return -2;
  int dtype = buf[2];
  int ndim = buf[3];
  if (ndim > 4) return -3;
  int64_t off = 4;
  int64_t total = 1;
  for (int i = 0; i < ndim; ++i) {
    if (off + 4 > len) return -4;
    int32_t d = (buf[off] << 24) | (buf[off + 1] << 16) |
                (buf[off + 2] << 8) | buf[off + 3];
    dims_out[i] = d;
    total *= d;
    off += 4;
  }
  *ndim_out = ndim;
  if (dtype != 0x08) return -5;  // unsigned byte only
  if (total > out_capacity) return -6;
  if (off + total > len) return -7;
  for (int64_t i = 0; i < total; ++i)
    data_out[i] = static_cast<float>(buf[off + i]);
  return 0;
}

// CIFAR-10 binary format: records of [label u8][3072 u8 RGB planes].
// Fills labels (1-based, reference convention) and CHW float images.
int bigdl_parse_cifar(const uint8_t* buf, int64_t len, float* images_out,
                      float* labels_out, int64_t max_records) {
  const int64_t rec = 1 + 3 * 32 * 32;
  int64_t n = len / rec;
  if (n > max_records) n = max_records;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* r = buf + i * rec;
    labels_out[i] = static_cast<float>(r[0]) + 1.0f;
    const uint8_t* px = r + 1;
    float* dst = images_out + i * 3 * 32 * 32;
    for (int64_t j = 0; j < 3 * 32 * 32; ++j)
      dst[j] = static_cast<float>(px[j]);
  }
  return static_cast<int>(n);
}

// ------------------------------------------------ augmenting batch loader
// The loader is templated on the pixel type; the float instantiation
// normalizes during the copy (the classic MTLabeledBGRImgToBatch shape),
// the uint8 instantiation copies raw crops so the batch crosses the
// host->device link at 1/4 the float32 bytes and (x - mean) / std runs on
// device.

}  // extern "C" (reopened below; the template can't have C linkage)

template <typename Tpix>
struct LoaderT {
  const Tpix* images;    // [n, c, h, w] source (borrowed)
  const float* labels;   // [n]
  int64_t n;
  int c, h, w;           // source geometry
  int crop_h, crop_w;    // output geometry
  int pad;               // zero-pad before crop (CIFAR style)
  int batch;
  bool flip, train;
  bool normalize;        // only meaningful for Tpix=float
  float mean[8], std_[8];
  uint64_t seed;

  std::vector<std::vector<Tpix>> img_bufs;
  std::vector<std::vector<float>> lbl_bufs;
  std::queue<int> ready;
  std::queue<int> free_bufs;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free, cv_drained;
  int next_waiters = 0;  // guarded by mu; consumers inside next()
  std::atomic<bool> stop{false};
  std::atomic<int64_t> cursor{0};

  static LoaderT* create(const Tpix* images, const float* labels, int64_t n,
                         int c, int h, int w, int crop_h, int crop_w,
                         int pad, int batch, int flip, int train,
                         const float* mean, const float* std_,
                         bool normalize, int num_threads, int prefetch,
                         uint64_t seed) {
    if (n <= 0 || c <= 0 || c > 8 || batch <= 0 || prefetch <= 0 ||
        num_threads <= 0)
      return nullptr;
    // A crop larger than the padded source would make the random-offset
    // modulus non-positive (wild uint64 offsets -> silently zeroed
    // batches).
    if (crop_h <= 0 || crop_w <= 0 || pad < 0 || crop_h > h + 2 * pad ||
        crop_w > w + 2 * pad)
      return nullptr;
    auto* L = new LoaderT();
    L->images = images;
    L->labels = labels;
    L->n = n;
    L->c = c; L->h = h; L->w = w;
    L->crop_h = crop_h; L->crop_w = crop_w;
    L->pad = pad;
    L->batch = batch;
    L->flip = flip != 0;
    L->train = train != 0;
    L->normalize = normalize;
    for (int i = 0; i < c && i < 8; ++i) {
      L->mean[i] = mean ? mean[i] : 0.0f;
      L->std_[i] = (std_ && std_[i] != 0.0f) ? std_[i] : 1.0f;
    }
    L->seed = seed;
    const int64_t out_px = int64_t(c) * crop_h * crop_w;
    for (int i = 0; i < prefetch; ++i) {
      L->img_bufs.emplace_back(size_t(batch) * out_px);
      L->lbl_bufs.emplace_back(size_t(batch));
      L->free_bufs.push(i);
    }
    for (int t = 0; t < num_threads; ++t)
      L->workers.emplace_back(&LoaderT::worker, L, t);
    return L;
  }

  void worker(int tid) {
    std::mt19937_64 rng(seed + tid);
    const int64_t out_px = int64_t(c) * crop_h * crop_w;
    while (!stop.load()) {
      int buf_idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || !free_bufs.empty(); });
        if (stop.load()) return;
        buf_idx = free_bufs.front();
        free_bufs.pop();
      }
      Tpix* out = img_bufs[buf_idx].data();
      float* lbl = lbl_bufs[buf_idx].data();
      for (int b = 0; b < batch; ++b) {
        int64_t idx;
        if (train) {
          idx = static_cast<int64_t>(rng() % uint64_t(n));
        } else {
          idx = cursor.fetch_add(1) % n;
        }
        lbl[b] = labels[idx];
        const Tpix* src = images + idx * int64_t(c) * h * w;
        int off_y, off_x;
        bool do_flip = false;
        if (train) {
          off_y = int(rng() % uint64_t(h + 2 * pad - crop_h + 1)) - pad;
          off_x = int(rng() % uint64_t(w + 2 * pad - crop_w + 1)) - pad;
          do_flip = flip && (rng() & 1);
        } else {
          off_y = (h - crop_h) / 2;
          off_x = (w - crop_w) / 2;
        }
        Tpix* dst = out + b * out_px;
        const bool interior = off_y >= 0 && off_x >= 0 &&
                              off_y + crop_h <= h && off_x + crop_w <= w;
        for (int ch = 0; ch < c; ++ch) {
          const float m = mean[ch], s = std_[ch];
          for (int y = 0; y < crop_h; ++y) {
            int sy = y + off_y;
            Tpix* drow = dst + (int64_t(ch) * crop_h + y) * crop_w;
            if (!normalize && interior && !do_flip) {
              std::memcpy(drow, src + (int64_t(ch) * h + sy) * w + off_x,
                          size_t(crop_w) * sizeof(Tpix));
              continue;
            }
            for (int x = 0; x < crop_w; ++x) {
              int sx = do_flip ? (crop_w - 1 - x) + off_x : x + off_x;
              float v = 0.0f;
              if (sy >= 0 && sy < h && sx >= 0 && sx < w)
                v = float(src[(int64_t(ch) * h + sy) * w + sx]);
              drow[x] = normalize ? Tpix((v - m) / s) : Tpix(v);
            }
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.push(buf_idx);
      }
      cv_ready.notify_one();
    }
  }

  // Copies the next ready batch into out_images/out_labels. Blocks until
  // one is available. Returns the batch size, or 0 if the loader is
  // stopping.
  int next(Tpix* out_images, float* out_labels) {
    int buf_idx;
    {
      std::unique_lock<std::mutex> lk(mu);
      ++next_waiters;
      cv_ready.wait(lk, [&] { return stop.load() || !ready.empty(); });
      if (ready.empty()) {  // stopping with nothing buffered
        if (--next_waiters == 0) cv_drained.notify_all();
        return 0;
      }
      buf_idx = ready.front();
      ready.pop();
    }
    std::memcpy(out_images, img_bufs[buf_idx].data(),
                img_bufs[buf_idx].size() * sizeof(Tpix));
    std::memcpy(out_labels, lbl_bufs[buf_idx].data(),
                lbl_bufs[buf_idx].size() * sizeof(float));
    {
      std::lock_guard<std::mutex> lk(mu);
      free_bufs.push(buf_idx);
    }
    cv_free.notify_one();
    const int result = batch;
    {
      // Decrementing the waiter count is the LAST touch of this object:
      // once it hits zero, destroy() may delete `this` as soon as the
      // notify is delivered and the lock released.
      std::lock_guard<std::mutex> lk(mu);
      if (--next_waiters == 0) cv_drained.notify_all();
    }
    return result;
  }

  void destroy() {
    {
      // stop must flip under mu: a thread between its predicate check and
      // blocking would otherwise miss the only notify and sleep forever
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) t.join();
    {
      // A consumer may still be inside next() (e.g. __del__ racing a
      // data() generator at interpreter shutdown); deleting the mutex and
      // condvars out from under it would be a use-after-free.
      std::unique_lock<std::mutex> lk(mu);
      cv_drained.wait(lk, [&] { return next_waiters == 0; });
    }
    delete this;
  }
};

extern "C" {

void* bigdl_loader_create(const float* images, const float* labels,
                          int64_t n, int c, int h, int w, int crop_h,
                          int crop_w, int pad, int batch, int flip,
                          int train, const float* mean, const float* std_,
                          int num_threads, int prefetch, uint64_t seed) {
  return LoaderT<float>::create(images, labels, n, c, h, w, crop_h, crop_w,
                                pad, batch, flip, train, mean, std_,
                                /*normalize=*/true, num_threads, prefetch,
                                seed);
}

int bigdl_loader_next(void* handle, float* out_images, float* out_labels) {
  return static_cast<LoaderT<float>*>(handle)->next(out_images, out_labels);
}

void bigdl_loader_destroy(void* handle) {
  static_cast<LoaderT<float>*>(handle)->destroy();
}

void* bigdl_loader_u8_create(const uint8_t* images, const float* labels,
                             int64_t n, int c, int h, int w, int crop_h,
                             int crop_w, int pad, int batch, int flip,
                             int train, int num_threads, int prefetch,
                             uint64_t seed) {
  return LoaderT<uint8_t>::create(images, labels, n, c, h, w, crop_h,
                                  crop_w, pad, batch, flip, train,
                                  /*mean=*/nullptr, /*std=*/nullptr,
                                  /*normalize=*/false, num_threads,
                                  prefetch, seed);
}

int bigdl_loader_u8_next(void* handle, uint8_t* out_images,
                         float* out_labels) {
  return static_cast<LoaderT<uint8_t>*>(handle)->next(out_images,
                                                      out_labels);
}

void bigdl_loader_u8_destroy(void* handle) {
  static_cast<LoaderT<uint8_t>*>(handle)->destroy();
}

}  // extern "C"
