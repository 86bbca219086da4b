// Native pendulum-frame rasterizer: the port's own copy of the JAX
// package's native/rasterizer.cpp (built by latentdiffeq_torch/utils/
// native.py into build/native/, never into native/).
//
// C++ twin of the torch renderer in latentdiffeq_torch/pendulum_data.py
// (and of the JAX rasterizer in examples/pendulum/create_data.py) — the
// host-side equivalent of the reference's Luxor vector renderer
// (reference: examples/pendulum_friction-less/create_data.jl:65-117).
// Used by the data pipeline when rendering on the host is preferable to
// occupying the accelerator (large dataset generation, CPU-only boxes).
//
// Geometry (identical to the JAX path): 28x28 canvas, y down, origin at
// center; pivot at (0, -8.5); bob at pivot + L_vis*(cos(pi/2+angle),
// sin(pi/2+angle)) with FIXED L_vis; white discs (r=1.75) at bob+pivot,
// white rod capsule (half-width 1.875), black perpendicular tick at the
// rod midpoint, black hub disc (r/2) on the pivot; 1-px anti-aliasing.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline float aa(float dist, float edge) {
    return std::min(1.0f, std::max(0.0f, edge - dist + 0.5f));
}

inline float disc(float px, float py, float cx, float cy, float r) {
    const float d = std::hypot(px - cx, py - cy);
    return aa(d, r);
}

inline float capsule(float px, float py, float x0, float y0, float x1,
                     float y1, float half_w) {
    const float vx = x1 - x0, vy = y1 - y0;
    const float L2 = vx * vx + vy * vy;
    float t = L2 > 0.0f ? ((px - x0) * vx + (py - y0) * vy) / L2 : 0.0f;
    t = std::min(1.0f, std::max(0.0f, t));
    const float d = std::hypot(px - (x0 + t * vx), py - (y0 + t * vy));
    return aa(d, half_w);
}

void render_one(float angle, float pend_len, float radius,
                float rod_thickness, int h, int w, float* out) {
    const float pivot_x = 0.0f, pivot_y = -8.5f;
    const float a1 = static_cast<float>(M_PI) / 2.0f + angle;
    const float bob_x = pivot_x + pend_len * std::cos(a1);
    const float bob_y = pivot_y + pend_len * std::sin(a1);

    const float mid_x = (pivot_x + bob_x) / 2.0f;
    const float mid_y = (pivot_y + bob_y) / 2.0f;
    const float rod_len = std::max(std::hypot(bob_x - pivot_x,
                                              bob_y - pivot_y), 1e-6f);
    const float dir_x = (bob_x - pivot_x) / rod_len;
    const float dir_y = (bob_y - pivot_y) / rod_len;
    // perpendicular tick (the reference's rotated "|" glyph)
    const float perp_x = -dir_y, perp_y = dir_x;
    const float tick_half = 2.4f;

    for (int row = 0; row < h; ++row) {
        const float py = static_cast<float>(row) - (h - 1) / 2.0f;
        for (int col = 0; col < w; ++col) {
            const float px = static_cast<float>(col) - (w - 1) / 2.0f;

            float white = disc(px, py, bob_x, bob_y, radius);
            white = std::max(white, disc(px, py, pivot_x, pivot_y, radius));
            white = std::max(white,
                             capsule(px, py, pivot_x, pivot_y, bob_x, bob_y,
                                     rod_thickness / 2.0f));

            const float tick = capsule(
                px, py, mid_x - tick_half * perp_x, mid_y - tick_half * perp_y,
                mid_x + tick_half * perp_x, mid_y + tick_half * perp_y, 0.5f);
            const float hub = disc(px, py, pivot_x, pivot_y, radius / 2.0f);

            out[row * w + col] = white * (1.0f - tick) * (1.0f - hub);
        }
    }
}

}  // namespace

extern "C" {

// angles: (n_traj * T) row-major; out: (n_traj * T * h * w)
void ldq_render_trajectories(const float* angles, int64_t n_traj, int64_t T,
                             float pend_len, float radius,
                             float rod_thickness, int32_t h, int32_t w,
                             float* out) {
    const int64_t frame = static_cast<int64_t>(h) * w;
    for (int64_t i = 0; i < n_traj * T; ++i) {
        render_one(angles[i], pend_len, radius, rod_thickness, h, w,
                   out + i * frame);
    }
}

}  // extern "C"
