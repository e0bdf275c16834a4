// Native exact-integer radix-2 FFT/IFFT engine.
//
// C++ implementation of the framework's golden arithmetic — the same
// bit-level semantics as intfftk/golden/int_model.py (which mirrors the
// reference RTL: /root/reference/src/vhdl/fft/int_dif2_fly.vhd,
// int_dit2_fly.vhd, twiddle/rom_twiddle_int.vhd, twiddle/row_twiddle_tay.vhd,
// math/cmult/int_cmult_dsp48.vhd).  Role in the framework:
//   * independent second oracle (C++ vs NumPy vs JAX triple agreement),
//   * fast host-side reference for large N / wide configs where the
//     vectorized NumPy model would fall back to object dtype,
//   * the compute core of the native streaming runtime (runtime/stream).
//
// Products/accumulations run in __int128; storage is int64 (supports any
// configuration with output width <= 63 bits — wider belongs to the Python
// bigint path).  Exposed as a plain C ABI for ctypes.
//
// Build: make -C native   (produces libintfft_golden.so)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i64 = int64_t;
using i128 = __int128;

constexpr int kTaylorStage = 11;   // config.TAYLOR_STAGE
constexpr int kCoarseBits = 9;     // config.TAYLOR_COARSE_BITS

inline i64 round_half_away(double x) {
  return static_cast<i64>(x >= 0 ? std::floor(x + 0.5) : std::ceil(x - 0.5));
}

inline i64 wrap_width(i128 v, int w) {
  if (w >= 63) return static_cast<i64>(v);
  const i128 m = (i128)1 << (w - 1);
  const i128 mask = ((i128)1 << w) - 1;
  return static_cast<i64>(((v + m) & mask) - m);
}

inline i64 neg_guarded(i64 x) { return x >= 0 ? -x : -x - 1; }

inline i64 round_half_up(i64 v) { return (v >> 1) + (v & 1); }

inline i64 magnitude(int width) {
  return width < 18 ? (((i64)1 << (width - 1)) - 1)
                    : (((i64)1 << (width - 2)) - 1);
}

struct Tables {
  // per twiddle order p (2..stages-1): 2^p entries
  std::vector<std::vector<i64>> re, im;
};

// quarter-wave table of 2^depth_bits entries (rom_twiddle_int.vhd:148-156)
static void quarter_table(int depth_bits, int width, std::vector<i64>& re,
                          std::vector<i64>& im) {
  const i64 mag = magnitude(width);
  const int n = 1 << depth_bits;
  re.resize(n);
  im.resize(n);
  const double step = M_PI / (double)((i64)1 << (depth_bits + 1));
  for (int i = 0; i < n; ++i) {
    const double th = i * step;
    re[i] = round_half_away(mag * std::cos(th));
    im[i] = round_half_away(mag * std::sin(-th));
  }
}

// integer first-order Taylor correction (row_twiddle_tay.vhd:134-268).
// new_ser selects the XSER="NEW" (DSP48E2) constant set: XSHIFT 21 and
// MATHPI = pi * 2^(11-ii) (:123-148); default is XSER="OLD" (DSP48E1).
// The USE_MLT generic needs no switch: its ROM and DSP delta products are
// bit-identical (MATHPI*cnt < pi*2^14 < 2^16, so the ROM's 16-bit wrap
// never engages).
static void taylor_correct(i64& re, i64& im, i64 count, int stage_ii,
                           bool new_ser) {
  const int xshift = new_ser ? 21 : 23;
  const int pi_shift = new_ser ? 11 : 13;
  const i64 mathpi =
      (i64)(M_PI * (double)((i64)1 << (pi_shift - stage_ii)) + 0.5);
  const i64 mpi = (mathpi * count) & 0xFFFF;
  const i64 mpx = mpi >> 1;
  auto rnd_shift = [&](i128 v) -> i64 {
    i128 t = v >> (xshift - 1);
    return (i64)((t >> 1) + (t & 1));
  };
  const i64 r0 = re, i0 = im;
  re = rnd_shift(((i128)r0 << xshift) + (i128)i0 * mpx);
  im = rnd_shift(((i128)i0 << xshift) - (i128)r0 * mpx);
}

// full stage table of order p (rom_twiddle_int.vhd quarter-wave + fold,
// Taylor interpolation for p >= 11 unless forced to exact ROM).
// gen: 0 auto/taylor_old, 1 rom, 2 taylor_new (XSER="NEW" constants)
static void stage_twiddles(int p, int width, int gen,
                           std::vector<i64>& out_re, std::vector<i64>& out_im) {
  const i64 n = (i64)1 << p;
  out_re.resize(n);
  out_im.resize(n);
  if (p == 0) { out_re[0] = 1; out_im[0] = 0; return; }
  if (p == 1) { out_re = {1, 0}; out_im = {0, -1}; return; }

  std::vector<i64> qre, qim;
  const bool taylor = (p >= kTaylorStage) && gen != 1;
  const int table_bits = taylor ? kCoarseBits : p - 1;
  quarter_table(table_bits, width, qre, qim);
  const i64 addr_mask = ((i64)1 << (p - 1)) - 1;
  for (i64 k = 0; k < n; ++k) {
    const i64 addr = k & addr_mask;
    const bool div = (k >> (p - 1)) & 1;
    i64 re, im;
    if (!taylor) {
      re = qre[addr];
      im = qim[addr];
    } else {
      const int low_bits = p - 1 - kCoarseBits;
      const i64 addrx = addr >> low_bits;
      re = qre[addrx];
      im = qim[addrx];
    }
    if (div) {  // quadrant fold: x(-j) => (re,im) -> (im,-re)
      const i64 t = re;
      re = im;
      im = -t;
    }
    if (taylor) {
      const int low_bits = p - 1 - kCoarseBits;
      const i64 count = addr & (((i64)1 << low_bits) - 1);
      taylor_correct(re, im, count, p - kTaylorStage, gen == 2);
    }
    out_re[k] = re;
    out_im[k] = im;
  }
}

struct Cfg {
  int n, stages;
  int mode;       // 1 unscaled, 0 scaled
  int rounding;   // 1 round-half-up, 0 truncate
  int data_width, twiddle_width;
  int twiddle_gen;  // 0 auto/taylor_old, 1 rom, 2 taylor_new
  int bypass;
  int shift() const {
    return twiddle_width < 19 ? twiddle_width - 1 : twiddle_width - 2;
  }
  int stage_input_width(int s) const {
    return mode ? data_width + s : data_width;
  }
};

inline void cmult(i64 br, i64 bi, i64 c, i64 d, int shift, int out_w,
                  i64& pr, i64& pi) {
  i128 r = (i128)br * c - (i128)bi * d;
  i128 i = (i128)bi * c + (i128)br * d;
  pr = wrap_width(r >> shift, out_w);
  pi = wrap_width(i >> shift, out_w);
}

static void bitrev_permute(i64* re, i64* im, int n, int stages,
                           std::vector<i64>& tmp_r, std::vector<i64>& tmp_i) {
  tmp_r.assign(re, re + n);
  tmp_i.assign(im, im + n);
  for (int i = 0; i < n; ++i) {
    int r = 0;
    for (int b = 0; b < stages; ++b) r |= ((i >> b) & 1) << (stages - 1 - b);
    re[i] = tmp_r[r];
    im[i] = tmp_i[r];
  }
}

static void transform_one(i64* xr, i64* xi, const Cfg& cfg, const Tables& tw,
                          bool inverse, std::vector<i64>& tr,
                          std::vector<i64>& ti) {
  const int n = cfg.n, nl = cfg.stages;
  const bool scale = cfg.mode == 0;
  const bool rnd = cfg.rounding == 1;

  if (inverse) bitrev_permute(xr, xi, n, nl, tr, ti);
  if (cfg.bypass) {
    if (!inverse) bitrev_permute(xr, xi, n, nl, tr, ti);
    return;
  }

  for (int s = 0; s < nl; ++s) {
    const int p = inverse ? s : nl - 1 - s;
    const int h = 1 << p;
    const int in_w = cfg.stage_input_width(s);
    const int out_w = in_w + 1 - (scale ? 1 : 0);
    const i64* wre = p >= 2 ? tw.re[p].data() : nullptr;
    const i64* wim = p >= 2 ? tw.im[p].data() : nullptr;
    for (int q = 0; q < n / (2 * h); ++q) {
      i64* ar = xr + (size_t)q * 2 * h;
      i64* ai = xi + (size_t)q * 2 * h;
      i64* br = ar + h;
      i64* bi = ai + h;
      for (int k = 0; k < h; ++k) {
        i64 A_r = ar[k], A_i = ai[k], B_r = br[k], B_i = bi[k];
        if (!inverse) {
          // DIF: X = A+B, Y = (A-B)*W   (int_dif2_fly.vhd)
          i64 sr, si, dr, di;
          if (scale && !rnd) {
            sr = (A_r >> 1) + (B_r >> 1);
            si = (A_i >> 1) + (B_i >> 1);
            dr = (A_r >> 1) - (B_r >> 1);
            di = (A_i >> 1) - (B_i >> 1);
          } else if (scale && rnd) {
            sr = round_half_up(A_r + B_r);
            si = round_half_up(A_i + B_i);
            dr = round_half_up(A_r - B_r);
            di = round_half_up(A_i - B_i);
          } else {
            sr = A_r + B_r; si = A_i + B_i;
            dr = A_r - B_r; di = A_i - B_i;
          }
          sr = wrap_width(sr, out_w); si = wrap_width(si, out_w);
          dr = wrap_width(dr, out_w); di = wrap_width(di, out_w);
          i64 yr, yi;
          if (p == 0) { yr = dr; yi = di; }
          else if (p == 1) {
            if (k & 1) { yr = di; yi = neg_guarded(dr); }
            else { yr = dr; yi = di; }
          } else {
            cmult(dr, di, wre[k], wim[k], cfg.shift(), out_w, yr, yi);
          }
          ar[k] = sr; ai[k] = si; br[k] = yr; bi[k] = yi;
        } else {
          // DIT: X = A + B*conj(W), Y = A - B*conj(W)  (int_dit2_fly.vhd)
          i64 bwr, bwi;
          if (p == 0) { bwr = B_r; bwi = B_i; }
          else if (p == 1) {
            if (k & 1) { bwr = neg_guarded(B_i); bwi = B_r; }
            else { bwr = B_r; bwi = B_i; }
          } else {
            cmult(B_r, B_i, wre[k], -wim[k], cfg.shift(), in_w, bwr, bwi);
          }
          i64 oar, oai, obr, obi;
          if (scale && !rnd) {
            oar = (A_r >> 1) + (bwr >> 1);
            oai = (A_i >> 1) + (bwi >> 1);
            obr = (A_r >> 1) - (bwr >> 1);
            obi = (A_i >> 1) - (bwi >> 1);
          } else if (scale && rnd) {
            oar = round_half_up(A_r + bwr);
            oai = round_half_up(A_i + bwi);
            obr = round_half_up(A_r - bwr);
            obi = round_half_up(A_i - bwi);
          } else {
            oar = A_r + bwr; oai = A_i + bwi;
            obr = A_r - bwr; obi = A_i - bwi;
          }
          ar[k] = wrap_width(oar, out_w);
          ai[k] = wrap_width(oai, out_w);
          br[k] = wrap_width(obr, out_w);
          bi[k] = wrap_width(obi, out_w);
        }
      }
    }
  }
  if (!inverse) bitrev_permute(xr, xi, n, nl, tr, ti);
}

}  // namespace

extern "C" {

// In-place exact integer transform of [batch, n] int64 arrays.
// mode: 1 unscaled, 0 scaled; rounding: 0 truncate, 1 round-half-up;
// twiddle_gen: 0 auto (Taylor for p>=11, XSER="OLD"), 1 rom (exact
// tables), 2 taylor_new (XSER="NEW" constants);
// Returns 0 on success, nonzero on invalid arguments.
int intfft_exec(int64_t* re, int64_t* im, int64_t batch, int n, int mode,
                int rounding, int data_width, int twiddle_width,
                int twiddle_gen, int inverse, int bypass) {
  if (n < 8 || (n & (n - 1)) || !re || !im) return 1;
  if (data_width < 8 || data_width > 52) return 2;
  if (twiddle_width < 16 || twiddle_width > 27) return 3;
  Cfg cfg;
  cfg.n = n;
  cfg.stages = 0;
  while ((1 << cfg.stages) < n) ++cfg.stages;
  cfg.mode = mode;
  cfg.rounding = rounding;
  cfg.data_width = data_width;
  cfg.twiddle_width = twiddle_width;
  cfg.twiddle_gen = twiddle_gen;
  cfg.bypass = bypass;
  const int out_w = mode ? data_width + cfg.stages : data_width;
  if (out_w > 63) return 4;  // bigint territory: use the Python model

  Tables tw;
  tw.re.resize(cfg.stages);
  tw.im.resize(cfg.stages);
  for (int p = 2; p < cfg.stages; ++p)
    stage_twiddles(p, twiddle_width, cfg.twiddle_gen, tw.re[p], tw.im[p]);

  std::vector<i64> tr, ti;
  for (int64_t b = 0; b < batch; ++b)
    transform_one(re + (size_t)b * n, im + (size_t)b * n, cfg, tw,
                  inverse != 0, tr, ti);
  return 0;
}

// Exact stage twiddle stream of order p (for table parity tests).
int intfft_stage_twiddles(int64_t* out_re, int64_t* out_im, int p, int width,
                          int twiddle_gen) {
  if (p < 0 || p > 20 || width < 16 || width > 27) return 1;
  std::vector<i64> re, im;
  stage_twiddles(p, width, twiddle_gen, re, im);
  std::memcpy(out_re, re.data(), re.size() * sizeof(i64));
  std::memcpy(out_im, im.data(), im.size() * sizeof(i64));
  return 0;
}

}  // extern "C"
