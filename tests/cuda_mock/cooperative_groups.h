// The grid group of the CPU stand-in (cuda_runtime.h beside it).
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { mock::grid->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
