"""The port imports and runs with jax and flax blocked: in a fresh
interpreter where importing either raises, import every module of
mvgformer_tpu_torch (run/, runtime/, parallel/, utils/visualization and
profiling, the tools ported from the root tools/ and the benches and
graft entry ported from the root scripts among them) and run a toy
forward
and eval step on the CPU, through the gather and through each windowed
layer-1 impl, one training step (matcher, criterion, corner sampler,
optimizer), the train and validate CLIs on the synthetic smoke config
(datasets, prefetch, checkpoint, NMS, evaluation), the fast trainer and
the bone-length extraction; and, statically, no file of the port imports
jax, flax or the JAX package."""

import ast
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    sys.modules["flax"] = None
    import importlib, pkgutil
    import torch
    torch.set_num_threads(1)  # toy sizes; the suite runs workers in parallel
    import mvgformer_tpu_torch
    for mod in pkgutil.walk_packages(mvgformer_tpu_torch.__path__,
                                     "mvgformer_tpu_torch."):
        importlib.import_module(mod.name)
    assert {"mvgformer_tpu_torch.run.train", "mvgformer_tpu_torch.run.validate",
            "mvgformer_tpu_torch.run.generate_video",
            "mvgformer_tpu_torch.parallel.mesh",
            "mvgformer_tpu_torch.parallel.collectives",
            "mvgformer_tpu_torch.utils.visualization",
            "mvgformer_tpu_torch.utils.profiling",
            "mvgformer_tpu_torch.runtime",
            "mvgformer_tpu_torch.tools.ap_train_fast",
            "mvgformer_tpu_torch.tools.ap_ablation",
            "mvgformer_tpu_torch.tools.ap_eval_driver",
            "mvgformer_tpu_torch.tools.ap_spread_report",
            "mvgformer_tpu_torch.tools.extract_bone_lengths",
            "mvgformer_tpu_torch.tools.verify_checkpoint",
            "mvgformer_tpu_torch.tools.bench_host_pipeline",
            "mvgformer_tpu_torch.bench", "mvgformer_tpu_torch.bench_detail",
            "mvgformer_tpu_torch.graft_entry"} <= set(sys.modules)
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.core.infer import make_eval_step
    from mvgformer_tpu_torch.data.synthetic import make_batch
    from mvgformer_tpu_torch.models.mvgformer import MVGFormer

    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DECODER.d_model = 32
    cfg.DECODER.dim_feedforward = 64
    cfg.DECODER.nhead = 4
    cfg.DECODER.num_decoder_layers = 2
    cfg.DECODER.num_instance = 16
    cfg.DECODER.inference_topk_queries = 8
    cfg.DECODER.inference_point_topm = 4
    cfg.DECODER.triangulation_method = "jacobi"
    cfg.POSE_RESNET.NUM_DECONV_FILTERS = [32, 32, 32]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    model = MVGFormer(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    batch = make_batch(cfg, seed=1, device="cpu")
    pred = make_eval_step(cfg, model, 0.1)(batch)
    assert pred.shape == (1, 16, 15, 5), pred.shape
    assert not torch.isnan(pred).any()
    from mvgformer_tpu_torch.models.mvgformer import build_layer1_window_plan
    for impl in ("xla", "pallas", "pallas_dma"):
        cfg.DECODER.layer1_window_impl = impl
        plan = build_layer1_window_plan(cfg, batch.view_data, device="cpu")
        pred, esc = make_eval_step(cfg, model, 0.1, window_plan=plan,
                                   with_escape_telemetry=True)(batch)
        assert pred.shape == (1, 16, 15, 5), pred.shape
        assert not torch.isnan(pred).any() and float(esc) < 1e-5
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_train_step)
    state, tx = create_train_state(cfg, model)
    state, metrics = make_train_step(cfg, model, tx)(
        state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and metrics["total"].isfinite(), metrics
    import tempfile
    from mvgformer_tpu_torch.run import train as train_cli
    from mvgformer_tpu_torch.run import validate as validate_cli
    with tempfile.TemporaryDirectory() as out:
        args = ["--cfg", "configs/synthetic_smoke.yaml", "--device", "cpu",
                f"OUTPUT_DIR={out}", "DATASET.MAX_DATA_NUM=2"]
        res = train_cli.main(args + ["--max_steps", "1"])
        assert res["steps"] == 1, res
        validate_cli.main(args + ["--model_path", res["ckpt_dir"]])
        from mvgformer_tpu_torch.tools import (ap_train_fast,
                                               extract_bone_lengths)
        fast = ap_train_fast.main(["--device", "cpu", "--out", out, "--cfg",
                                   "configs/synthetic_smoke.yaml",
                                   "DATASET.MAX_DATA_NUM=1",
                                   "TRAIN.END_EPOCH=1"])
        assert fast["steps"] == 1, fast
        extract_bone_lengths.main(["--cfg", "configs/synthetic_smoke.yaml",
                                   "--device", "cpu", "--out", out,
                                   "--max_frames", "2"])
    jax_side = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "flax", "jaxlib",
                                             "mvgformer_tpu")
                      and sys.modules[m] is not None)
    print("LOADED", jax_side)
""")


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = proc.stdout.strip().splitlines()[-1]
    # nothing of jax, flax or the JAX package is loaded
    assert loaded == "LOADED []", loaded


FORBIDDEN = ("mvgformer_tpu", "jax", "jaxlib", "flax")


def _imported_roots(path):
    """The top-level package of every import statement in a file."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _port_files():
    # chip_smoke.py and the card diagnoses run where JAX is not installed
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "vp_card_diagnosis.py"),
             os.path.join(REPO, "tests", "sync_diagnosis.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mvgformer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_port_file_imports_jax_or_the_jax_package():
    """Static guard: no module of the port, not chip_smoke.py and not
    tests/vp_card_diagnosis.py or tests/sync_diagnosis.py names
    mvgformer_tpu (as opposed to mvgformer_tpu_torch), jax or flax in an
    import, wherever the import sits (top level, function, branch)."""
    files = _port_files()
    assert len(files) > 30
    bad = [f"{os.path.relpath(path, REPO)}:{line} imports {name}"
           for path in files for line, name in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad
