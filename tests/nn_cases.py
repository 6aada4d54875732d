"""Inputs that walk the edges of the nearest-neighbour kernel's split of the
targets (`xchu_slam_tpu_torch/csrc/nn_kernel.cu`: slices × 16 sub-slices,
merged in index order):
ties across slices and sub-slices, ragged N and M, clouds smaller than one
tile or one staging round, masks that empty whole slices. The smoke run and
the tests hold the kernel, its first version and the plain version to each
other on them."""

from __future__ import annotations

import numpy as np


def edge_cases(rng):
    """(name, src, tgt, mask) in numpy. The first is the ICP shape (4 slices
    of 16 sub-slices of 256 targets on 132 SMs); the rest walk the edges of
    the kernel's split of the targets."""
    def cloud(n, scale):
        return rng.normal(size=(n, 3)).astype(np.float32) * scale

    cases = [("4096x16384", cloud(4096, 30.0), cloud(16384, 30.0),
              np.ones(16384, bool)),
             ("ragged 1000x3000", cloud(1000, 10.0), cloud(3000, 10.0),
              np.ones(3000, bool))]
    m = np.ones(4096, bool)
    m[4096 // 3:4096 // 2] = False
    cases.append(("masked stretch", cloud(1024, 10.0), cloud(4096, 10.0), m))
    m = np.zeros(2048, bool)
    m[5] = True
    cases.append(("all but one masked", cloud(1024, 1.0), cloud(2048, 1.0), m))
    cases.append(("all masked", cloud(1024, 1.0), cloud(2048, 1.0),
                  np.zeros(2048, bool)))
    # every target 8 times, twice in each slice; sources on top of targets
    base = cloud(2048, 30.0)
    dup = np.tile(base, (8, 1))
    src = np.concatenate([base[::2], cloud(3072, 30.0)])
    cases.append(("duplicates across slices", src, dup, np.ones(16384, bool)))
    m = np.ones(16384, bool)
    m[:4096] = False  # the first slice masked: the third copy must win
    cases.append(("duplicates, first slice masked", src, dup, m))
    # every target 64 times, once in each warp's sub-slice
    cases.append(("duplicates across sub-slices", cloud(300, 5.0),
                  np.tile(cloud(256, 5.0), (64, 1)), np.ones(16384, bool)))
    cases.append(("ragged 4100x16001", cloud(4100, 30.0), cloud(16001, 30.0),
                  rng.random(16001) > 0.3))
    cases.append(("N below one tile 50x16384", cloud(50, 30.0),
                  cloud(16384, 30.0), np.ones(16384, bool)))
    cases.append(("M below one round 4096x20", cloud(4096, 5.0), cloud(20, 5.0),
                  np.ones(20, bool)))
    cases.append(("M below slices x round 4096x100", cloud(4096, 5.0),
                  cloud(100, 5.0), rng.random(100) > 0.5))
    cases.append(("M 700", cloud(4096, 5.0), cloud(700, 5.0), np.ones(700, bool)))
    cases.append(("16 slices 1024x16384", cloud(1024, 30.0), cloud(16384, 30.0),
                  rng.random(16384) > 0.2))
    m = np.zeros(16384, bool)
    m[10000:10300] = True  # slices 0, 1, 3 and most of 2 empty
    cases.append(("one slice left", cloud(4096, 30.0), cloud(16384, 30.0), m))
    m = np.ones(16384, bool)
    m[:4096 + 256] = False   # slice 0 and one more warp empty
    m[8192:12288] = False    # slice 2 empty
    cases.append(("slices emptied", cloud(4096, 30.0), cloud(16384, 30.0), m))
    return cases
