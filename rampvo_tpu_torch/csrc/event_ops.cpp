// Event-to-tensor builders of the host data path (port of
// rampvo_tpu/data/csrc/event_ops.cpp; ref utils/transformers.py).
//
// The per-voxel accumulation is the host's hot loop: numpy's ufunc.at
// over 100k-500k events costs tens of ms where these loops take about a
// millisecond. Each sum is accumulated in the order of the numpy version
// (data/representations.py), so the results equal it bit for bit; built
// with -ffp-contract=off so no multiply-add is fused. Plain C interface,
// loaded with ctypes (../data/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Count-binned polarity stack: event k of n goes to bin
// floor(bins * k / n) in float32; the float sums are cast to int8 as
// numpy's astype(int8). out [bins, H, W].
void event_stack(int8_t* out, const uint16_t* x, const uint16_t* y,
                 const int8_t* p, int64_t n, int64_t bins, int64_t H,
                 int64_t W) {
    const int64_t plane = H * W;
    std::vector<float> acc(bins * plane, 0.0f);
    for (int64_t k = 0; k < n; ++k) {
        const int64_t b = (int64_t)((float)bins * (float)k / (float)n);
        const int64_t xi = x[k], yi = y[k];
        if (xi < W && yi < H && b < bins) {
            acc[b * plane + yi * W + xi] += (float)p[k];
        }
    }
    for (int64_t i = 0; i < bins * plane; ++i) {
        out[i] = (int8_t)acc[i];
    }
}

// Bilinear-in-time voxel grid, not normalized (the caller normalizes).
// Two passes as numpy's two add.at calls: every event's weight on its
// lower bin, then every event's weight on the upper bin. out [bins, H, W].
void voxel_grid(float* out, const uint16_t* x, const uint16_t* y,
                const int64_t* t, const int8_t* p, int64_t n, int64_t bins,
                int64_t H, int64_t W) {
    const int64_t plane = H * W;
    std::memset(out, 0, sizeof(float) * bins * plane);
    if (n == 0) return;
    const double t0 = (double)t[0];
    double dT = (double)t[n - 1] - t0;
    if (dT == 0.0) dT = 1.0;
    for (int upper = 0; upper < 2; ++upper) {
        for (int64_t k = 0; k < n; ++k) {
            const double ts = (double)(bins - 1) * ((double)t[k] - t0) / dT;
            const double ti = std::floor(ts);
            const float dt = (float)(ts - ti);
            const int64_t xi = x[k], yi = y[k];
            if (ti < 0 || xi >= W || yi >= H) continue;
            const int64_t b = (int64_t)ti + upper;
            if (b >= bins) continue;
            const float wgt = upper ? dt : 1.0f - dt;
            out[b * plane + yi * W + xi] += (float)p[k] * wgt;
        }
    }
}

}  // extern "C"
