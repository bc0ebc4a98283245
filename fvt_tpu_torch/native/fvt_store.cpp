// fvt_store: native feature-store row gather.
//
// The training hot path reads windows of rows from per-trial .npy arrays
// (the disk contract of the upstream base/dataset.py:603-619).  The
// numpy route (np.load(mmap)[indices]) pays python indexing + a temporary
// per window; this library does the gather with mmap + memcpy and
// multi-threaded copies for large windows, called from Python via ctypes
// (the call releases the GIL, so the loader's thread pool overlaps).
//
// Build: fvt_tpu_torch.data.native_store.ensure_built() compiles it with
// g++ into build/ at the repository root.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cerrno>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct MappedFile {
    void* data = nullptr;
    size_t size = 0;
    bool ok = false;
    MappedFile() = default;
    MappedFile(const MappedFile&) = delete;
    MappedFile& operator=(const MappedFile&) = delete;
    MappedFile(MappedFile&& o) noexcept
        : data(o.data), size(o.size), ok(o.ok) {
        o.data = nullptr;
        o.size = 0;
        o.ok = false;
    }
    // RAII so the mapping is released on EVERY exit path, including the
    // catch-all in the extern "C" wrappers
    ~MappedFile() { if (data) ::munmap(data, size); }
};

MappedFile map_file(const char* path) {
    MappedFile mf;
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return mf;
    struct stat st;
    if (::fstat(fd, &st) != 0) { ::close(fd); return mf; }
    mf.size = static_cast<size_t>(st.st_size);
    mf.data = ::mmap(nullptr, mf.size, PROT_READ, MAP_SHARED, fd, 0);
    ::close(fd);
    if (mf.data == MAP_FAILED) { mf.data = nullptr; return mf; }
    mf.ok = true;
    return mf;
}

// Readahead hint for ONLY the row span a gather will touch — used by
// fvt_gather_rows, whose callers (train-path window gathers) read one
// random clip per call: a blanket whole-file MADV_WILLNEED there is
// pure read amplification on a multi-hundred-MB video.npy.
// fvt_gather_resize_u8 deliberately keeps the whole-file hint instead:
// its caller (challenge/eval inference) consumes each video as a
// SEQUENCE of overlapping window gathers, and the whole-file hint at
// the first window pipelines readahead for all later windows (measured
// in-bench: 10.0k frames/s loader vs 5.7-7.5k with span-only advise).
void advise_rows(const MappedFile& mf, int64_t header, int64_t row_bytes,
                 const int64_t* idx, int64_t n) {
    if (n <= 0) return;
    int64_t lo = idx[0], hi = idx[0];
    for (int64_t i = 1; i < n; ++i) {
        if (idx[i] < lo) lo = idx[i];
        if (idx[i] > hi) hi = idx[i];
    }
    const long page = ::sysconf(_SC_PAGESIZE);
    int64_t begin = header + lo * row_bytes;
    int64_t end = header + (hi + 1) * row_bytes;
    begin -= begin % page;
    if (end > static_cast<int64_t>(mf.size))
        end = static_cast<int64_t>(mf.size);
    ::madvise(static_cast<uint8_t*>(mf.data) + begin,
              static_cast<size_t>(end - begin), MADV_WILLNEED);
}

void copy_range(const uint8_t* base, int64_t header, int64_t row_bytes,
                const int64_t* idx, int64_t begin, int64_t end,
                uint8_t* out) {
    for (int64_t i = begin; i < end; ++i) {
        std::memcpy(out + i * row_bytes,
                    base + header + idx[i] * row_bytes,
                    static_cast<size_t>(row_bytes));
    }
}

}  // namespace

extern "C" {

// Gather n rows of row_bytes each from a .npy file (data starts at
// header_offset) into out.  Returns 0 on success, negative errno-style
// codes on failure (-3: an index would read past the mapped file — e.g.
// a truncated or header-inconsistent file; -4: a C++ exception, e.g.
// thread/allocation failure under memory pressure — exceptions must not
// escape the C ABI into ctypes, where they would std::terminate the
// process instead of letting Python fall back to numpy).  Thread-safe;
// spawns worker threads for large copies.
int fvt_gather_rows(const char* path, int64_t header_offset,
                    int64_t row_bytes, const int64_t* idx, int64_t n,
                    uint8_t* out, int num_threads) try {
    if (header_offset < 0 || row_bytes <= 0 || n < 0) return -2;
    MappedFile mf = map_file(path);
    if (!mf.ok) return -1;

    const uint8_t* base = static_cast<const uint8_t*>(mf.data);
    const int64_t total = n * row_bytes;
    const int64_t data_bytes = static_cast<int64_t>(mf.size) - header_offset;
    if (row_bytes > data_bytes) return -2;
    const int64_t max_row = data_bytes / row_bytes;  // rows actually on disk
    for (int64_t i = 0; i < n; ++i) {
        if (idx[i] < 0 || idx[i] >= max_row) return -3;
    }
    advise_rows(mf, header_offset, row_bytes, idx, n);

    int nt = num_threads;
    if (nt <= 1 || total < (1 << 20)) {
        copy_range(base, header_offset, row_bytes, idx, 0, n, out);
    } else {
        if (nt > 16) nt = 16;
        std::vector<std::thread> workers;
        int64_t chunk = (n + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t b = t * chunk;
            int64_t e = b + chunk < n ? b + chunk : n;
            if (b >= e) break;
            workers.emplace_back(copy_range, base, header_offset,
                                 row_bytes, idx, b, e, out);
        }
        for (auto& w : workers) w.join();
    }
    return 0;
} catch (...) {
    return -4;
}

}  // extern "C"

// Fused gather + separable antialiased resize for uint8 video frames.
//
// Reads frames (rows of a (N, H, W, C) uint8 .npy) straight from the
// mmap and resizes each to (S, S, C) with caller-provided dense weight
// matrices wh (S*H) / ww (S*W) — the exact triangle kernel the Python /
// device paths use (fvt_tpu/data/host_resize.py).  Only the non-zero
// band of each weight row is walked (the 256->48 kernel is ~11 of 256
// taps), the uint8->float conversion happens inside the FMA loop (no
// H*W*C float frame is ever materialized), and the whole call runs
// without the GIL.  Values are rounded to uint8 exactly like
// resize_frames_uint8 (rint, clip to [0, 255]).
//
// This exists because challenge-inference is host-bound on 1-core
// machines: the dense sgemm formulation costs 22 MFLOP/frame where the
// band walk costs ~1.3 MFLOP/frame.
namespace {

struct Band { int64_t start; int64_t len; };

std::vector<Band> bands_of(const float* w, int64_t s, int64_t n) {
    std::vector<Band> bands(static_cast<size_t>(s));
    for (int64_t o = 0; o < s; ++o) {
        const float* row = w + o * n;
        int64_t b = 0, e = n;
        while (b < n && row[b] == 0.0f) ++b;
        while (e > b && row[e - 1] == 0.0f) --e;
        bands[static_cast<size_t>(o)] = {b, e - b};
    }
    return bands;
}

// Column pass with the channel count as a compile-time constant: the
// c=3 inner loops fully unroll and keep the accumulators in registers
// (a runtime c defeated unrolling and dominated the per-frame cost).
template <int64_t C>
void col_pass(const float* acc, int64_t w, int64_t s, const float* ww,
              const std::vector<Band>& wb, uint8_t* dst) {
    for (int64_t o = 0; o < s; ++o) {
        const float* row = acc + o * w * C;
        for (int64_t p = 0; p < s; ++p) {
            const Band& b = wb[static_cast<size_t>(p)];
            float col[C] = {};
            for (int64_t k = 0; k < b.len; ++k) {
                const float wk = ww[p * w + b.start + k];
                const float* src = row + (b.start + k) * C;
                for (int64_t ch = 0; ch < C; ++ch)
                    col[ch] += wk * src[ch];
            }
            for (int64_t ch = 0; ch < C; ++ch) {
                float v = std::nearbyintf(col[ch]);
                v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
                dst[(o * s + p) * C + ch] = static_cast<uint8_t>(v);
            }
        }
    }
}

void col_pass_generic(const float* acc, int64_t w, int64_t c, int64_t s,
                      const float* ww, const std::vector<Band>& wb,
                      uint8_t* dst, float* col) {
    for (int64_t o = 0; o < s; ++o) {
        const float* row = acc + o * w * c;
        for (int64_t p = 0; p < s; ++p) {
            const Band& b = wb[static_cast<size_t>(p)];
            for (int64_t ch = 0; ch < c; ++ch) col[ch] = 0.0f;
            for (int64_t k = 0; k < b.len; ++k) {
                const float wk = ww[p * w + b.start + k];
                const float* src = row + (b.start + k) * c;
                for (int64_t ch = 0; ch < c; ++ch)
                    col[ch] += wk * src[ch];
            }
            for (int64_t ch = 0; ch < c; ++ch) {
                float v = std::nearbyintf(col[ch]);
                v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
                dst[(o * s + p) * c + ch] = static_cast<uint8_t>(v);
            }
        }
    }
}

void resize_frames_range(const uint8_t* base, int64_t header,
                         int64_t row_bytes, const int64_t* idx,
                         int64_t begin, int64_t end,
                         int64_t h, int64_t w, int64_t c, int64_t s,
                         const float* wh, const float* ww,
                         const std::vector<Band>& hb,
                         const std::vector<Band>& wb,
                         uint8_t* out) {
    const int64_t wc = w * c;
    std::vector<float> acc(static_cast<size_t>(s * wc));
    std::vector<float> col(static_cast<size_t>(c));
    for (int64_t i = begin; i < end; ++i) {
        const uint8_t* frame = base + header + idx[i] * row_bytes;
        // rows: acc[o, :] = sum_k wh[o, k] * frame[k, :]
        for (int64_t o = 0; o < s; ++o) {
            float* dst = acc.data() + o * wc;
            std::memset(dst, 0, static_cast<size_t>(wc) * sizeof(float));
            const Band& b = hb[static_cast<size_t>(o)];
            for (int64_t k = 0; k < b.len; ++k) {
                const float wk = wh[o * h + b.start + k];
                const uint8_t* src = frame + (b.start + k) * wc;
                for (int64_t j = 0; j < wc; ++j)
                    dst[j] += wk * static_cast<float>(src[j]);
            }
        }
        // cols: out[i, o, p, :] = sum_k ww[p, k] * acc[o, k, :]
        uint8_t* dst = out + i * s * s * c;
        if (c == 3) {
            col_pass<3>(acc.data(), w, s, ww, wb, dst);
        } else if (c == 1) {
            col_pass<1>(acc.data(), w, s, ww, wb, dst);
        } else {
            col_pass_generic(acc.data(), w, c, s, ww, wb, dst,
                             col.data());
        }
    }
}

}  // namespace

extern "C" {

int fvt_gather_resize_u8(const char* path, int64_t header_offset,
                         const int64_t* idx, int64_t n,
                         int64_t h, int64_t w, int64_t c, int64_t s,
                         const float* wh, const float* ww,
                         uint8_t* out, int num_threads) try {
    if (header_offset < 0 || n < 0 || h <= 0 || w <= 0 || c <= 0 || s <= 0)
        return -2;
    const int64_t row_bytes = h * w * c;  // uint8
    MappedFile mf = map_file(path);
    if (!mf.ok) return -1;
    const int64_t data_bytes = static_cast<int64_t>(mf.size) - header_offset;
    if (row_bytes > data_bytes) return -2;
    const int64_t max_row = data_bytes / row_bytes;
    for (int64_t i = 0; i < n; ++i) {
        if (idx[i] < 0 || idx[i] >= max_row) return -3;
    }
    // whole-file hint on purpose — see advise_rows' comment
    ::madvise(mf.data, mf.size, MADV_WILLNEED);
    const uint8_t* base = static_cast<const uint8_t*>(mf.data);
    const std::vector<Band> hb = bands_of(wh, s, h);
    const std::vector<Band> wb = bands_of(ww, s, w);

    int nt = num_threads;
    if (nt <= 1 || n < 32) {
        resize_frames_range(base, header_offset, row_bytes, idx, 0, n,
                            h, w, c, s, wh, ww, hb, wb, out);
    } else {
        if (nt > 16) nt = 16;
        std::vector<std::thread> workers;
        int64_t chunk = (n + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t b = t * chunk;
            int64_t e = b + chunk < n ? b + chunk : n;
            if (b >= e) break;
            workers.emplace_back(resize_frames_range, base, header_offset,
                                 row_bytes, idx, b, e, h, w, c, s, wh, ww,
                                 std::cref(hb), std::cref(wb), out);
        }
        for (auto& wk : workers) wk.join();
    }
    return 0;
} catch (...) {
    return -4;
}

}  // extern "C"
