"""Run a calibrated optical-flow configuration on one pair and save the flow
as ``.mat`` (the port's counterpart of ``examples/run_config.py``).

    python3 -m opticalflow_ri_tpu_torch.harness.run_config PyHSchunck_Fs3_4
    python3 -m opticalflow_ri_tpu_torch.harness.run_config LiuSE_denseLK_Fs2_0_PyrLvls2 \\
        --im1 path/a.tif --im2 path/b.tif --out flow.mat --device cpu

With no images it runs the synthetic 512x512 PIV pair
(``utils.synthetic.particle_image_pair``, seed 0).  The pair runs through
``compile.compiled_pipeline``: on the card one CUDA graph, on the CPU the
eager path.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main():
    from opticalflow_ri_tpu_torch.compile import compiled_pipeline
    from opticalflow_ri_tpu_torch.configs import CONFIGS
    from opticalflow_ri_tpu_torch.utils.io import load_image, save_flow

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", choices=sorted(CONFIGS), metavar="config",
                    help="one of: " + ", ".join(sorted(CONFIGS)))
    ap.add_argument("--im1", default=None)
    ap.add_argument("--im2", default=None)
    ap.add_argument("--out", default=None, help="output .mat path (default <config>.mat)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    if (args.im1 is None) != (args.im2 is None):
        ap.error("give both --im1 and --im2, or neither")
    if args.im1 is not None:
        im1, im2 = load_image(args.im1), load_image(args.im2)
    else:
        print("no input images given; using the synthetic 512x512 PIV pair", file=sys.stderr)
        from opticalflow_ri_tpu_torch.utils.synthetic import particle_image_pair

        im1, im2, _, _ = particle_image_pair(shape=(512, 512), seed=0)

    u, v = compiled_pipeline(args.config)(im1, im2, device=args.device)
    u, v = np.asarray(u.cpu()), np.asarray(v.cpu())
    out = args.out or f"{args.config}.mat"
    save_flow(u, v, out)
    print(f"{args.config}: U in [{u.min():.3f}, {u.max():.3f}], "
          f"V in [{v.min():.3f}, {v.max():.3f}] -> {out}")


if __name__ == "__main__":
    main()
