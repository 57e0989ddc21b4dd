// The constants that the flash backward's kernels share (flash_bwd.cu's
// K2a and K2b, flash_bwd_fused.cu's K3): their CTAs' threads and the
// base-2 logarithm's factors.
#pragma once

namespace {

constexpr int NT = 256;   // threads of a CTA: two warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

}  // namespace
