"""The raw panorama store for end-to-end pretraining (torch port of
``vln_hamt_tpu/run/build_image_store.py``; numpy and the native sampler).

    python -m vln_hamt_torch.run.build_image_store --connectivity_dir DIR --pano_dir PANOS \\
        --output STORE/            # a directory of {scan}_{vp}.npy records
    python -m vln_hamt_torch.run.build_image_store ... --output STORE.lmdb   # needs lmdb

Parity target: ``preprocess/build_image_lmdb.py``: the 36 views of every
viewpoint rendered at (248, 330) uint8, one record per viewpoint, keyed
``{scan}_{viewpoint}``. The sink is LMDB when ``--output`` ends in
``.lmdb`` (``lmdb`` is imported then only), else a ``.npy`` directory;
``pretrain/image_data.py``'s stores read both.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .precompute_features import _load_equirect, find_panorama, load_viewpoint_ids


def main(argv=None):
    p = argparse.ArgumentParser(description="build the raw 36-view image store")
    p.add_argument("--connectivity_dir", required=True)
    p.add_argument("--pano_dir", required=True)
    p.add_argument("--output", required=True,
                   help=".lmdb path or directory for .npy records")
    p.add_argument("--height", type=int, default=248)
    p.add_argument("--width", type=int, default=330)
    p.add_argument("--vfov_deg", type=float, default=60.0)
    args = p.parse_args(argv)

    from ..native import sample_panorama

    vps = load_viewpoint_ids(args.connectivity_dir)
    env = None
    if args.output.endswith(".lmdb"):
        import lmdb

        env = lmdb.open(args.output, map_size=int(1e12))
    else:
        os.makedirs(args.output, exist_ok=True)
    t0 = time.perf_counter()
    try:
        for scan, vp in vps:
            eq = _load_equirect(find_panorama(args.pano_dir, scan, vp))
            views = sample_panorama(eq, np.deg2rad(args.vfov_deg), args.width, args.height)
            if env is not None:
                with env.begin(write=True) as txn:
                    txn.put(f"{scan}_{vp}".encode("ascii"), views.tobytes())
            else:
                np.save(os.path.join(args.output, f"{scan}_{vp}.npy"), views)
    finally:
        if env is not None:
            env.close()
    result = {"viewpoints": len(vps), "seconds": time.perf_counter() - t0}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
