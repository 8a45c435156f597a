// Host staging library of the data pipeline (the port's copy of the JAX
// package's native/staging.cc; the code is the same, only these comments
// differ).
//
// Decoded uint8 RGB clips become normalized float32 NHWC buffers: a plain
// unpack into a padded buffer (stage_clip), the sparse separable resize of a
// sampled train or eval transform (resize_normalize_clip), and the strided
// gather of the slow stream (gather_strided). A pthread pool stages the
// frames of a clip in parallel; its Submit and Wait take calls from several
// loader threads at once (one mutex guards the queue and the count, and a
// Wait returns once no job of any caller is outstanding).
//
// A plain C ABI, bound with ctypes by tubedetr_tpu_torch/data/native.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct ThreadPool {
  explicit ThreadPool(int n_threads) : stop_(false) {
    for (int i = 0; i < n_threads; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
          {
            std::lock_guard<std::mutex> lk(mu_);
            if (--outstanding_ == 0) done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  void Submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      ++outstanding_;
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return outstanding_ == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::condition_variable done_cv_;
  bool stop_;
  long outstanding_ = 0;
};

// One frame: uint8 HWC -> float32 HWC normalized, written into a padded
// (pad_h, pad_w) destination row-major buffer. Scale/shift fold /255 and
// ImageNet mean/std into a single FMA per element.
void StageFrame(const uint8_t* src, float* dst, int h, int w, int pad_h,
                int pad_w, const float* scale, const float* shift) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * w * 3;
    float* drow = dst + static_cast<size_t>(y) * pad_w * 3;
    for (int x = 0; x < w; ++x) {
      drow[x * 3 + 0] = srow[x * 3 + 0] * scale[0] + shift[0];
      drow[x * 3 + 1] = srow[x * 3 + 1] * scale[1] + shift[1];
      drow[x * 3 + 2] = srow[x * 3 + 2] * scale[2] + shift[2];
    }
    // zero right padding
    if (w < pad_w)
      std::memset(drow + static_cast<size_t>(w) * 3, 0,
                  sizeof(float) * 3 * (pad_w - w));
  }
  for (int y = h; y < pad_h; ++y)
    std::memset(dst + static_cast<size_t>(y) * pad_w * 3, 0,
                sizeof(float) * 3 * pad_w);
}

}  // namespace

extern "C" {

void* staging_pool_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  return new ThreadPool(n_threads);
}

void staging_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

// Stage a whole clip: (t, h, w, 3) uint8 -> (t, pad_h, pad_w, 3) float32.
// mean/std are per-channel in [0,1] units (ImageNet); the /255 is folded in.
void stage_clip(void* pool, const uint8_t* src, float* dst, int t, int h,
                int w, int pad_h, int pad_w, const float* mean,
                const float* std_) {
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.0f / (255.0f * std_[c]);
    shift[c] = -mean[c] / std_[c];
  }
  auto* tp = static_cast<ThreadPool*>(pool);
  const size_t src_frame = static_cast<size_t>(h) * w * 3;
  const size_t dst_frame = static_cast<size_t>(pad_h) * pad_w * 3;
  for (int i = 0; i < t; ++i) {
    const uint8_t* s = src + i * src_frame;
    float* d = dst + i * dst_frame;
    tp->Submit([=] { StageFrame(s, d, h, w, pad_h, pad_w, scale, shift); });
  }
  tp->Wait();
}

// Sparse separable resize + normalize for the data workers:
//
//   dst[o, p, c] = norm( sum_k sum_j Ah[o,k] * Aw[p,j] * src[k, j, c] )
//
// Ah (out_h x h) and Aw (out_w x w) arrive in CSR form; composed train
// transforms (resize -> crop -> resize collapsed by matrix product,
// tubedetr_tpu_torch/data/transforms.py) have only a handful of nonzeros per
// row, so this is O(nnz) instead of a dense matmul. The /255 and ImageNet
// mean/std fold into one FMA at the end (linear ops commute with the
// resize). The data workers launch no device work.
void resize_normalize_clip(void* pool, const uint8_t* src, float* dst, int t,
                           int h, int w, int out_h, int out_w,
                           const int32_t* ah_indptr, const int32_t* ah_idx,
                           const float* ah_val, const int32_t* aw_indptr,
                           const int32_t* aw_idx, const float* aw_val,
                           const float* mean, const float* std_,
                           int normalize) {
  float scale[3], shift[3];
  for (int c = 0; c < 3; ++c) {
    if (normalize) {
      scale[c] = 1.0f / (255.0f * std_[c]);
      shift[c] = -mean[c] / std_[c];
    } else {
      scale[c] = 1.0f / 255.0f;
      shift[c] = 0.0f;
    }
  }
  auto* tp = static_cast<ThreadPool*>(pool);
  const size_t src_frame = static_cast<size_t>(h) * w * 3;
  const size_t dst_frame = static_cast<size_t>(out_h) * out_w * 3;
  for (int i = 0; i < t; ++i) {
    const uint8_t* s = src + i * src_frame;
    float* d = dst + i * dst_frame;
    tp->Submit([=] {
      std::vector<float> tmp(static_cast<size_t>(out_h) * w * 3);
      // row contraction: tmp[o, x, c] = sum_k Ah[o,k] * src[k, x, c]
      for (int o = 0; o < out_h; ++o) {
        float* trow = tmp.data() + static_cast<size_t>(o) * w * 3;
        std::memset(trow, 0, sizeof(float) * w * 3);
        for (int32_t e = ah_indptr[o]; e < ah_indptr[o + 1]; ++e) {
          const float v = ah_val[e];
          const uint8_t* srow = s + static_cast<size_t>(ah_idx[e]) * w * 3;
          for (int x = 0; x < w * 3; ++x) trow[x] += v * srow[x];
        }
      }
      // column contraction + normalize
      for (int o = 0; o < out_h; ++o) {
        const float* trow = tmp.data() + static_cast<size_t>(o) * w * 3;
        float* drow = d + static_cast<size_t>(o) * out_w * 3;
        for (int p = 0; p < out_w; ++p) {
          float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
          for (int32_t e = aw_indptr[p]; e < aw_indptr[p + 1]; ++e) {
            const float v = aw_val[e];
            const float* px = trow + static_cast<size_t>(aw_idx[e]) * 3;
            acc0 += v * px[0];
            acc1 += v * px[1];
            acc2 += v * px[2];
          }
          drow[p * 3 + 0] = acc0 * scale[0] + shift[0];
          drow[p * 3 + 1] = acc1 * scale[1] + shift[1];
          drow[p * 3 + 2] = acc2 * scale[2] + shift[2];
        }
      }
    });
  }
  tp->Wait();
}

// Strided gather of the slow stream: copy frames [0, k, 2k, ...) of a staged
// float32 clip buffer into a contiguous slow buffer (both padded HWC).
void gather_strided(void* pool, const float* src, float* dst, int t,
                    int stride, int frame_elems) {
  auto* tp = static_cast<ThreadPool*>(pool);
  int n = (t + stride - 1) / stride;
  for (int i = 0; i < n; ++i) {
    const float* s = src + static_cast<size_t>(i) * stride * frame_elems;
    float* d = dst + static_cast<size_t>(i) * frame_elems;
    tp->Submit(
        [=] { std::memcpy(d, s, sizeof(float) * frame_elems); });
  }
  tp->Wait();
}

}  // extern "C"
