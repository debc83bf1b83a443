// The kernels' plain C interface: the extern "C" launchers that
// libhdrnet_kernels.so exports. Each .cu that defines one includes this
// header, and so does the native op library (hdrnet_torch/native/
// hdrnet_ops.cc, built by g++), so the compiler holds every definition
// and every C++ caller to one declaration. ops/_build.py gives ctypes the
// same argument types.
//
// Each launcher runs on `stream` (a cudaStream_t) and returns its
// cudaGetLastError() (0 on success); the plan returns the dynamic shared
// bytes of hdrnet_slice_apply_grid_bwd.

#pragma once

extern "C" {

// K2 (downsample.cu): the nearest s x s preview, channel-first float32.
int hdrnet_nearest_lowres(const void* frame, int is_u8, const void* iy,
                          const void* ix, void* out, int b, int h, int w,
                          int c, int s, void* stream);

// K2x (downsample_onehot.cu): the one-hot matmul preview (experiment).
int hdrnet_downsample_onehot(const void* frame, const void* iy,
                             const void* ix, void* out, int planes, int h,
                             int w, int s, int rows, void* stream);

// K1 and K7 (fused_slice_apply.cu): curves guide, slice, apply, clip.
int hdrnet_enhance_fused(const void* grid, const void* frame, int u8_in,
                         const void* params, void* out, int u8_out, int clip,
                         int b, int h, int w, int gh, int gw, int gd,
                         int y_off, int x_off, int h_total, int w_total,
                         float sy, float sx, void* stream);

// K6 and K7 (fused_slice_apply.cu): as K1, with the NN guide.
int hdrnet_enhance_fused_nn(const void* grid, const void* frame, int u8_in,
                            const void* params, int gc, void* out, int u8_out,
                            int clip, int b, int h, int w, int gh, int gw,
                            int gd, int y_off, int x_off, int h_total,
                            int w_total, float sy, float sx, void* stream);

// K3 (slice_apply.cu): slice-apply forward with an external guide.
int hdrnet_slice_apply_fwd(const void* grid, const void* guide,
                           const void* image, void* out, int b, int h, int w,
                           int gh, int gw, int gd, int n_in, int n_out,
                           int has_offset, int y_off, int h_total, float sy,
                           float sx, void* stream);

// K4 (slice_apply.cu): the guide and input cotangents.
int hdrnet_slice_apply_pix_bwd(const void* grid, const void* guide,
                               const void* image, const void* ct,
                               void* d_guide, void* d_image, int b, int h,
                               int w, int gh, int gw, int gd, int n_in,
                               int n_out, int has_offset, int y_off,
                               int h_total, float sy, float sx, void* stream);

// K5's plan (slice_apply.cu): its strips and scratch floats.
int hdrnet_slice_apply_grid_bwd_plan(int b, int h, int gh, int gw, int gd,
                                     int c_n, int y_off, int h_total,
                                     int pad_y, int* strips,
                                     long long* scratch_floats);

// K5 (slice_apply.cu): the grid cotangent, deterministic.
int hdrnet_slice_apply_grid_bwd(const void* guide, const void* image,
                                const void* ct, void* scratch, void* out,
                                int b, int h, int w, int gh, int gw, int gd,
                                int n_in, int n_out, int has_offset,
                                int y_off, int h_total, float sy, float sx,
                                int pad_y, int pad_x, int strips,
                                void* stream);

// pyramid_down (pyramid_levels.cu): one level of the Gaussian pyramid,
// float32 or uint8 in, float32 out, with the taps of both axes.
int hdrnet_pyramid_down(const void* src, int u8_in, const void* iy0,
                        const void* iy1, const void* fy, const void* ix0,
                        const void* ix1, const void* fx, void* dst, int b,
                        int h_in, int w_in, int h_out, int w_out,
                        void* stream);

// pyramid_up_add (pyramid_levels.cu): one coarse-to-fine step, with the
// clip and the uint8 requantize.
int hdrnet_pyramid_up_add(const void* coarse, const void* level,
                          const void* iy0, const void* iy1, const void* fy,
                          const void* ix0, const void* ix1, const void* fx,
                          void* dst, int clip, int u8_out, int b, int h_in,
                          int w_in, int h_out, int w_out, void* stream);

}  // extern "C"
