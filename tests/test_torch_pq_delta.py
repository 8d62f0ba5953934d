"""ROADMAP A4: the port's HV postprocessing at the production tile size,
1024², against the exact host pipeline, in binary PQ.

The port's fixed-pass path (`instance_map_batch_maps(use_kernels=True)` on
CPU tensors, which runs the plain twins of the B2-B4 kernels; `chip_smoke.py`
holds those twins bit-equal to the kernels on the card) segments
`eval/pq_delta.py`'s synthetic tiles (`make_gt_tile`: ≈450 touching
elliptical nuclei; `model_like_outputs`: blurred, noisy NP and HV maps),
relabelled as `process_wsi` relabels them. The oracle is the JAX package's
host pipeline `ops/hv_postproc_np.proc_np_hv` (cv2 and scipy, the
reference's exact algorithms), imported here as a host oracle. Gate: the
mean bPQ of the port differs from the oracle's by less than 0.002
(ROADMAP North star). Each test prints its tiles' figures and the labels
the fixed-pass compaction left out of range (ROADMAP C4); `-s` shows them.
"""

import numpy as np
import pytest
import torch

from cellvit_tpu.eval.pq_delta import _binary_pq, make_gt_tile, model_like_outputs
from cellvit_tpu.ops.hv_postproc_np import proc_np_hv
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch_maps
from cellvit_tpu_torch.ops.instance_stats import relabel_consecutive

torch.set_num_threads(1)

SIZE, N_CELLS = 1024, 450
#: |Δ bPQ| bound (ROADMAP North star, docs/PARITY.md)
DELTA_BPQ = 0.002


def _delta_bpq(n_tiles: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    exact, port, out_of_range, instances = [], [], [], []
    for _ in range(n_tiles):
        inst, _ = make_gt_tile(rng, SIZE, N_CELLS)
        np_prob, hv = model_like_outputs(rng, inst)
        oracle = proc_np_hv(np_prob, hv, object_size=10, ksize=21)
        maps = [torch.from_numpy(np.ascontiguousarray(a))[None]
                for a in (np_prob, hv[..., 0], hv[..., 1])]
        pred = instance_map_batch_maps(*maps, use_kernels=True)
        out_of_range.append(int((pred > SIZE * SIZE // 2 + 1).sum()))
        pred = relabel_consecutive(pred, SIZE * SIZE // 2 + 2)[0].numpy()
        exact.append(_binary_pq(inst, oracle))
        port.append(_binary_pq(inst, pred))
        instances.append((int(inst.max()), int(oracle.max()), int(pred.max())))
    report = {"tiles": n_tiles, "exact_bPQ": float(np.mean(exact)), "port_bPQ": float(np.mean(port)),
              "delta_bPQ": float(np.mean(port) - np.mean(exact)),
              "out_of_range_px_per_tile": out_of_range,
              "instances_gt_exact_port": instances}
    print(report)
    return report


def test_port_bpq_at_1024_matches_exact_pipeline():
    report = _delta_bpq(n_tiles=2, seed=0)
    assert report["exact_bPQ"] > 0.5, report  # the oracle scores sane segmentations
    assert abs(report["delta_bPQ"]) < DELTA_BPQ, report


@pytest.mark.slow
def test_port_bpq_at_1024_matches_exact_pipeline_many_tiles():
    report = _delta_bpq(n_tiles=16, seed=1)
    assert report["exact_bPQ"] > 0.5, report
    assert abs(report["delta_bPQ"]) < DELTA_BPQ, report
