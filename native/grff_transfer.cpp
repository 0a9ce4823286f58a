// Native GRFF transfer library: drop-in replacement for the external
// GRFF_DEM_Transfer.so binary the reference loads via ctypes
// (ref contract: script/synthetic_FF_map_single_thread.py:27-35 — argtypes
// [int32*, f64*, f64*, f64*, f64*, f64*, f64*] -> int, PyGET_MW symbol).
//
// Physics identical to raytracinggrff_jax/grff/physics.py (the float64
// parity reference): Appleton-Hartree magnetoionic modes, Dulk (1985)
// free-free opacity with piecewise Coulomb logarithm, Saha neutral-hydrogen
// collisional term (mechanism flag 4), per-voxel source areas (Parms[14]),
// evanescent-mode blocking, log-spaced frequency grid.
//
// Input layout (column-major Parms(15, Nz) exactly as the reference packs
// it, script/resample_with_ray_tracing.py:489-501):
//   Lparms[0]=Nz, Lparms[1]=Nf
//   Rparms[0]=pixel area cm^2, Rparms[1]=f0 Hz, Rparms[2]=dlog10 f
//   Parms[0]=ds cm, [1]=T K, [2]=n_e cm^-3, [3]=|B| G, [4]=theta deg,
//   [6]=mechanism flags (1 free-free, 2 gyroresonance, 4 neutrals),
//   [14]=per-voxel source area cm^2 (0 -> Rparms[0])
// Output RL(7, Nf) column-major: RL[0]=f GHz, RL[1]/RL[2]=tau_O/tau_X,
// RL[5]=O-mode flux SFU, RL[6]=X-mode flux SFU.
//
// Build: g++ -O3 -shared -fPIC -o GRFF_DEM_Transfer.so grff_transfer.cpp

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kCcgs = 2.998e10;
constexpr double kKb = 1.38065e-16;
constexpr double kMe = 9.1094e-28;
constexpr double kAUcm = 1.49599e13;
constexpr double kSfu = 1e-19;
constexpr double kFpeCoef = 8.93e3;     // f_pe = coef * sqrt(n_e)
constexpr double kFbCoef = 2.7992e6;    // f_B = coef * B
constexpr double kKappaFF = 9.786e-3;   // Dulk 1985 prefactor
constexpr double kSahaCoef = 2.4147e15;
constexpr double kChiHoverK = 1.5789e5;
constexpr double kSigmaEH = 3.5e-15;
constexpr double kPi = 3.14159265358979323846;

double coulomb_log(double te, double nu) {
  double v = (te < 2e5) ? 18.2 + 1.5 * std::log(te) - std::log(nu)
                        : 24.5 + std::log(te) - std::log(nu);
  return v > 0.0 ? v : 0.0;
}

// Appleton-Hartree n^2 for mode sigma (+1 O, -1 X); may be <= 0.
double refr_index_sq(double X, double Y, double theta, double sigma) {
  double st = std::sin(theta), ct = std::cos(theta);
  double yt2 = Y * st * Y * st;
  double yl2 = Y * ct * Y * ct;
  double omx = 1.0 - X;
  double root = std::sqrt(yt2 * yt2 / 4.0 + omx * omx * yl2);
  double denom = omx - yt2 / 2.0 + sigma * root;
  if (std::fabs(denom) < 1e-30) denom = 1e-30;
  return 1.0 - X * omx / denom;
}

// Exact magnetoionic polarization coupling F_sigma(theta) for thermal
// gyroresonance: projection of the cold-plasma mode polarization (Stix
// frame null vector) onto the electron-sense rotation about B. Twin of
// physics.gyro_polarization_coupling (see its derivation docstring);
// reduces to the QL (1 - sigma|cos|)^2/2 and captures the exact X/O
// asymmetry toward theta = 90 deg (O-mode coupling -> 0 like cos^2).
double gyro_coupling(double X, double Y, double theta, double sigma) {
  const double n2 = refr_index_sq(X, Y, theta, sigma);
  double omy2 = 1.0 - Y * Y;
  if (std::fabs(omy2) < 1e-12) omy2 = omy2 >= 0.0 ? 1e-12 : -1e-12;
  const double S = 1.0 - X / omy2;
  const double D = -X * Y / omy2;
  const double P = 1.0 - X;
  const double st = std::sin(theta), ct = std::cos(theta);
  const double a = n2 - S;
  const double dl = P - n2 * st * st;
  const double num = (a + D) * (a + D) * dl * dl;
  double den = (a * a + D * D) * dl * dl + a * a * n2 * n2 * ct * ct * st * st;
  if (den < 1e-38) den = 1e-38;
  return num / den;
}

// Thermal gyroresonance opacity summed over harmonics s=2..s_max [cm^-1]
// (mechanism flag 2, Parms[7] harmonic cap). Same Gaussian-layer form as
// raytracinggrff_jax/grff/physics.py:
//   kappa_s = (pi^2/(2c)) (nu_p^2/nu) F_sigma(theta) s^2 (s^2 beta^2
//             sin^2/2)^(s-1) / s!  *  s nu_B Gauss(nu - s nu_B)
// with the exact F_sigma above; |cos theta| floored at 0.01 in the line
// width only.
double gyro_kappa(double nu_p_sq, double nu_b_in, double te, double nu,
                  double theta, double sigma, int s_max) {
  const double nu_b = nu_b_in > 1.0 ? nu_b_in : 1.0;
  const double beta2 = kKb * te / (kMe * kCcgs * kCcgs);
  const double beta = std::sqrt(beta2);
  const double st = std::sin(theta);
  double act = std::fabs(std::cos(theta));
  if (act < 0.01) act = 0.01;
  const double f_sigma =
      gyro_coupling(nu_p_sq / (nu * nu), nu_b / nu, theta, sigma);
  const double pref = (kPi * kPi / (2.0 * kCcgs)) * nu_p_sq / nu * f_sigma;
  double log_arg = beta2 * st * st / 2.0;
  log_arg = std::log(log_arg > 1e-38 ? log_arg : 1e-38);

  double total = 0.0;
  for (int s = 2; s <= s_max; ++s) {
    const double sd = static_cast<double>(s);
    const double width = sd * nu_b * beta * act;
    const double log_term = 2.0 * std::log(sd) +
                            (sd - 1.0) * (log_arg + 2.0 * std::log(sd)) -
                            std::lgamma(sd + 1.0);
    const double d = nu - sd * nu_b;
    const double gauss = std::exp(-d * d / (2.0 * width * width)) /
                         (std::sqrt(2.0 * kPi) * width);
    total += sd * nu_b * std::exp(log_term) * gauss;
  }
  return pref * total;
}

}  // namespace

extern "C" int PyGET_MW(const int32_t* Lparms, const double* Rparms,
                        const double* Parms, const double* T,
                        const double* DEM, const double* /*DDM*/,
                        double* RL) {
  const int nz = Lparms[0];
  const int nf = Lparms[1];
  if (nz < 0 || nf <= 0) return 1;
  // DEM mode: Lparms[2] = NT >= 2 temperature nodes. T is the (NT,)
  // ascending grid in K, DEM the column-major (NT, Nz) differential
  // emission measure per voxel [cm^-5 K^-1, voxel path length folded into
  // the column]: the free-free term integrates the kernel over the DEM
  // (same moments as physics.dem_freefree_moments) while dispersion/
  // evanescence still use Parms[2] n_e and neutral/gyro terms Parms[1] T.
  // The reference always calls with Lparms[2..4] = 0 and dummy scalars
  // (script/synthetic_FF_map_single_thread.py:203-208) -> uniform-T path.
  // DDM mode (Lparms[4] != 0) stays unimplemented: status 2.
  if (Lparms[4] != 0) return 2;
  const int nt = Lparms[2];
  const bool dem_mode = nt > 0;
  if (dem_mode && nt < 2) return 1;
  std::vector<double> wq;   // trapezoid weights over the T grid
  if (dem_mode) {
    for (int t = 1; t < nt; ++t)
      if (!(T[t] > T[t - 1]) || !(T[t - 1] > 0.0)) return 1;
    wq.resize(nt);
    wq[0] = (T[1] - T[0]) / 2.0;
    for (int t = 1; t < nt - 1; ++t) wq[t] = (T[t + 1] - T[t - 1]) / 2.0;
    wq[nt - 1] = (T[nt - 1] - T[nt - 2]) / 2.0;
  }
  const double area0 = Rparms[0];
  const double f0 = Rparms[1];
  const double dlog = Rparms[2];

  for (int i = 0; i < nf; ++i) {
    const double nu = f0 * std::pow(10.0, dlog * i);
    double flux[2] = {0.0, 0.0};   // O, X
    double tau_tot[2] = {0.0, 0.0};
    bool blocked[2] = {false, false};

    for (int k = 0; k < nz; ++k) {
      const double* p = Parms + 15 * k;   // column k, Fortran order
      const double ds = p[0], te = p[1], ne = p[2], bb = p[3];
      const double theta = p[4] * kPi / 180.0;
      const int mech = static_cast<int>(p[6]);
      const int s_max = p[7] > 0.0 ? static_cast<int>(p[7]) : 30;
      const double area = (p[14] > 0.0) ? p[14] : area0;
      if (!(ds > 0.0) || !std::isfinite(ds) || !std::isfinite(te) ||
          !std::isfinite(ne) || !std::isfinite(bb))
        continue;
      if (!(mech & (1 | 2))) continue;   // no emission mechanism on

      const double nu_p_sq = kFpeCoef * kFpeCoef * ne;
      const double nu_b = kFbCoef * bb;
      const double X = nu_p_sq / (nu * nu);
      const double Y = nu_b / nu;
      const double lnlam = coulomb_log(te, nu);
      const double t32 = te * std::sqrt(te);

      double nu_en = 0.0;
      if (mech & 4) {
        double tsafe = te > 500.0 ? te : 500.0;
        double rhs = kSahaCoef * tsafe * std::sqrt(tsafe) *
                     std::exp(-kChiHoverK / tsafe);
        double n_h = ne * ne / (rhs > 1e-30 ? rhs : 1e-30);
        double vmean = std::sqrt(8.0 * kKb * tsafe / (kPi * kMe));
        nu_en = n_h * kSigmaEH * vmean;
      }

      // DEM free-free kernel moments for this voxel (mode-independent;
      // the magnetoionic 1/(n_sigma eff^2) factors out of the T integral)
      double m_k = 0.0, t_eff = 0.0;
      if (dem_mode && (mech & 1)) {
        double m_j = 0.0;
        const double* dem_col = DEM + static_cast<long>(nt) * k;
        for (int t = 0; t < nt; ++t) {
          const double g = coulomb_log(T[t], nu);
          const double wd = wq[t] * dem_col[t] * g / (T[t] * std::sqrt(T[t]));
          m_k += wd;
          m_j += wd * T[t];
        }
        t_eff = m_j / (m_k > 1e-300 ? m_k : 1e-300);
      }

      for (int m = 0; m < 2; ++m) {
        const double sigma = (m == 0) ? 1.0 : -1.0;
        const double n2 = refr_index_sq(X, Y, theta, sigma);
        if (n2 <= 0.0) {           // evanescent: mode blocked
          flux[m] = 0.0;
          tau_tot[m] = INFINITY;
          blocked[m] = true;
          continue;
        }
        const double n_sig = std::sqrt(n2 > 1e-12 ? n2 : 1e-12);
        const double eff = nu + sigma * nu_b * std::fabs(std::cos(theta));
        const double eff2 = eff * eff > 1e-30 ? eff * eff : 1e-30;
        double tau_ff = 0.0, tau_th = 0.0;
        if (mech & 1) {
          if (dem_mode) {
            tau_ff = kKappaFF * m_k / (n_sig * eff2);
          } else {
            tau_ff = kKappaFF * ne * ne * lnlam / (n_sig * eff2 * t32) * ds;
          }
          tau_th += nu_p_sq / eff2 * nu_en / (kCcgs * n_sig) * ds;
        }
        if (mech & 2)
          tau_th += gyro_kappa(nu_p_sq, nu_b, te, nu, theta, sigma, s_max)
                    * ds;
        const double tau = tau_ff + tau_th;
        // source temperature: DEM T_eff for the DEM free-free term,
        // Parms T for the single-temperature terms, opacity-weighted
        const double t_src =
            (dem_mode && (mech & 1))
                ? (tau_ff * t_eff + tau_th * te) / (tau > 1e-300 ? tau
                                                                 : 1e-300)
                : te;
        const double src_j = kKb * t_src * nu * nu / (kCcgs * kCcgs);
        const double att = std::exp(-tau);
        const double emit = -std::expm1(-tau);
        flux[m] = flux[m] * att +
                  src_j * emit * (area / (kAUcm * kAUcm)) / kSfu;
        if (!blocked[m]) tau_tot[m] += tau;
      }
    }

    double* rl = RL + 7 * i;   // column i, Fortran order
    rl[0] = nu / 1e9;
    rl[1] = tau_tot[0];
    rl[2] = tau_tot[1];
    rl[3] = 0.0;
    rl[4] = 0.0;
    rl[5] = flux[0];
    rl[6] = flux[1];
  }
  return 0;
}
