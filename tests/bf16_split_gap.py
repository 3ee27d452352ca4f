"""How far one training step's gradients move between a 2-frame batch and
the mean of two 1-frame steps on the same frames, in both packages, on the
CPU: the data-parallel split of chip_smoke.py's phase 20a (2 ranks x 1
frame against 1 process x 2 frames), without ranks.

    python tests/bf16_split_gap.py [--dtype bfloat16] [--size toy|mid]

The toy DQ config (tests/torch_parity.py, eigh, dropout 0) or `mid`, the
same at 5 views, 64 queries, d_model 64, 8 heads, 4 points and 192x128
images; JAX's weights in both packages and the port's gt match on both
sides. Prints one JSON line per comparison with the largest gap per leaf
as a share of the leaf's largest gradient (the frozen backbone left out),
the median over the leaves and the sampling_offsets leaves:

  port_split      the port's mean of the 1-frame steps against its
                  2-frame step (plain versions: the CPU runs no kernel);
  jax_split       the same for JAX's loss gradient;
  jax_mesh        JAX's 2-frame gradient placed by `make_mesh(2)` +
                  `shard_batch` on 2 of 8 virtual CPU devices, against
                  the unsharded one;
  port_vs_jax     the two packages' 2-frame gradients.
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mvgformer_tpu.core import criterion as jcrit  # noqa: E402
from mvgformer_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from mvgformer_tpu.models.matcher import MatchResult as JMatchResult  # noqa: E402
from mvgformer_tpu.models.mvgformer import MVGFormer as JMVGFormer  # noqa: E402
from mvgformer_tpu.parallel import make_mesh  # noqa: E402
from mvgformer_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from mvgformer_tpu_torch.core import criterion as pcrit  # noqa: E402
from mvgformer_tpu_torch.core import train  # noqa: E402
from mvgformer_tpu_torch.data.synthetic import batch_from_jax  # noqa: E402
from mvgformer_tpu_torch.parallel import DataParallel, shard_batch  # noqa: E402
from torch_parity import port_grads, port_model, toy_cfg  # noqa: E402

SIZES = {
    "toy": {},
    "mid": {"DATASET.CAMERA_NUM": 5, "DECODER.num_instance": 64,
            "DECODER.d_model": 64, "POSE_RESNET.NUM_DECONV_FILTERS":
            [64, 64, 64], "DECODER.nhead": 8, "DECODER.dec_n_points": 4,
            "NETWORK.IMAGE_SIZE": [192, 128]},
}


def gaps(got, want):
    """{leaf: max|got - want| / max|want|} over the trainable leaves."""
    out = {}
    for k, w in want.items():
        if k.startswith("backbone.") or k not in got:
            continue
        scale = np.abs(w).max()
        if scale > 0:
            out[k] = float(np.abs(got[k] - w).max() / scale)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--size", default="toy", choices=sorted(SIZES))
    args = parser.parse_args(argv)
    torch.set_num_threads(4)
    cfg = toy_cfg({"PARALLEL.COMPUTE_DTYPE": args.dtype,
                   **SIZES[args.size]})
    jm = JMVGFormer(cfg=cfg)
    jb = jax_make_batch(cfg, batch_size=2, seed=3, num_people=2)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                                  "init_ref": jax.random.PRNGKey(2)}, jb)
    variables = jax.tree_util.tree_map(
        np.asarray, {k: variables[k] for k in ("params", "batch_stats")})
    model = port_model(cfg, variables)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = batch_from_jax(jb)
    frames = [shard_batch(batch, DataParallel(rank=r, world=2))
              for r in range(2)]

    def port_grad(b):
        model.load_state_dict(weights)
        state, tx = train.create_train_state(cfg, model)
        train.make_train_step(cfg, model, tx)(state, b)
        return {k: p.grad.float().numpy().copy()
                for k, p in model.named_parameters() if p.grad is not None}

    def loss_fn(params, batch_stats, b, match, init_refs):
        outs = jm.apply({"params": params, "batch_stats": batch_stats}, b,
                        query_mask=match.query_mask, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        losses = jcrit.compute_losses(cfg, outs, b, match,
                                      init_reference=init_refs,
                                      num_replicas=2)
        return losses["total"]

    grad = jax.jit(jax.grad(loss_fn))

    def jax_grad(jbatch, pbatch):
        B = pbatch.views.shape[0]
        m = pcrit.match_queries(
            cfg, model.initial_reference_points_static(B), pbatch)
        match = JMatchResult(query_idx=jnp.asarray(m.query_idx.numpy()),
                             gt_valid=jnp.asarray(m.gt_valid.numpy()),
                             query_mask=jnp.asarray(m.query_mask.numpy()))
        g = grad(variables["params"], variables["batch_stats"], jbatch,
                 match, jm.initial_reference_points_static(B))
        g = port_grads(cfg, variables, jax.tree_util.tree_map(np.asarray, g))
        return {k: v.float().numpy() for k, v in g.items()}

    port2 = port_grad(batch)
    port1 = [port_grad(f) for f in frames]
    jax2 = jax_grad(jb, batch)
    jax_mesh = jax_grad(jax_shard_batch(jb, make_mesh(2)), batch)
    jax1 = [jax_grad(jax.tree_util.tree_map(lambda x: x[r:r + 1], jb),
                     frames[r]) for r in range(2)]

    def mean(pair):
        return {k: (pair[0][k] + pair[1][k]) / 2 for k in pair[0]}

    for name, got, want in (("port_split", mean(port1), port2),
                            ("jax_split", mean(jax1), jax2),
                            ("jax_mesh", jax_mesh, jax2),
                            ("port_vs_jax", port2, jax2)):
        g = gaps(got, want)
        worst = sorted(g.items(), key=lambda kv: -kv[1])
        print(json.dumps({
            "comparison": name, "size": args.size, "dtype": args.dtype,
            "max": worst[0][1], "max_leaf": worst[0][0],
            "median": float(np.median(list(g.values()))),
            "largest": worst[1:6],
            "sampling_offsets": {k: v for k, v in g.items()
                                 if "sampling_offsets" in k}}))


if __name__ == "__main__":
    main()
