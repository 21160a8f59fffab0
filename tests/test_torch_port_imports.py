"""oneshotdet_tpu_torch stands alone: importing it loads neither JAX nor
flax (nor PIL, which only the decoding of a non-PPM image imports, nor
OpenCV, which the webcam tool imports in its ``main``), and no
source of the port (nor chip_smoke.py) imports jax, flax or the JAX package
``oneshotdet_tpu``.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "oneshotdet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "flax", "oneshotdet_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_neither_jax_nor_flax():
    code = (
        "import sys\n"
        "import oneshotdet_tpu_torch, oneshotdet_tpu_torch.csrc, oneshotdet_tpu_torch.ops.roi_align\n"
        "import oneshotdet_tpu_torch.models, oneshotdet_tpu_torch.predictor\n"
        "import oneshotdet_tpu_torch.utils.weights, oneshotdet_tpu_torch.data\n"
        "import oneshotdet_tpu_torch.engine, oneshotdet_tpu_torch.data.evaluation\n"
        "import oneshotdet_tpu_torch.ops.roi_head_fused, oneshotdet_tpu_torch.utils.comm\n"
        "import oneshotdet_tpu_torch.ops.group_norm, oneshotdet_tpu_torch.ops.roi_align_v3\n"
        "import oneshotdet_tpu_torch.ops.roi_align_v4, oneshotdet_tpu_torch.tools.tune_roi_head\n"
        "import oneshotdet_tpu_torch.tools.tune_roialign_v3, oneshotdet_tpu_torch.tools.ablate_v4\n"
        "import oneshotdet_tpu_torch.tools.ablate_roi_align, oneshotdet_tpu_torch.tools.ablate_resize\n"
        "import oneshotdet_tpu_torch.ops.resize, oneshotdet_tpu_torch.data.build\n"
        "import oneshotdet_tpu_torch.data.image_io, oneshotdet_tpu_torch.tools.test_net\n"
        "import oneshotdet_tpu_torch.utils.checkpoint, oneshotdet_tpu_torch.utils.logger\n"
        "import oneshotdet_tpu_torch.utils.synthetic, oneshotdet_tpu_torch.utils.model_zoo\n"
        "import oneshotdet_tpu_torch.utils.c2_import, oneshotdet_tpu_torch.tools.train_net\n"
        "import oneshotdet_tpu_torch.tools.remove_solver_states\n"
        "import oneshotdet_tpu_torch.export, oneshotdet_tpu_torch.ops.library\n"
        "import oneshotdet_tpu_torch.tools.export_model, oneshotdet_tpu_torch.tools.oneshot_demo\n"
        "import oneshotdet_tpu_torch.structures.segmentation_mask\n"
        "import oneshotdet_tpu_torch.data.transforms\n"
        "import oneshotdet_tpu_torch.models.mask_head, oneshotdet_tpu_torch.models.keypoint_head\n"
        "import oneshotdet_tpu_torch.models.roi_heads, oneshotdet_tpu_torch.structures.keypoint\n"
        "import oneshotdet_tpu_torch.ops.quant, oneshotdet_tpu_torch.tools.quant_drift\n"
        "import oneshotdet_tpu_torch.tools.webcam\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'oneshotdet_tpu', 'PIL', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_scan_covers_every_module_of_the_port():
    names = {str(p.relative_to(ROOT)) for p in PORT_SOURCES}
    for path in ("oneshotdet_tpu_torch/engine/inference.py",
                 "oneshotdet_tpu_torch/data/evaluation/coco_eval.py",
                 "oneshotdet_tpu_torch/data/evaluation/coco_metrics.py",
                 "oneshotdet_tpu_torch/ops/roi_head_fused.py", "chip_smoke.py",
                 "oneshotdet_tpu_torch/ops/group_norm.py", "oneshotdet_tpu_torch/ops/roi_align_v3.py",
                 "oneshotdet_tpu_torch/ops/roi_align_v4.py",
                 "oneshotdet_tpu_torch/tools/tune_roialign_v3.py",
                 "oneshotdet_tpu_torch/tools/ablate_v4.py",
                 "oneshotdet_tpu_torch/tools/tune_roi_head.py",
                 "oneshotdet_tpu_torch/tools/ablate_roi_align.py",
                 "oneshotdet_tpu_torch/tools/ablate_resize.py",
                 "oneshotdet_tpu_torch/ops/resize.py", "oneshotdet_tpu_torch/data/build.py",
                 "oneshotdet_tpu_torch/data/collate.py",
                 "oneshotdet_tpu_torch/data/datasets/coco.py",
                 "oneshotdet_tpu_torch/data/image_io.py",
                 "oneshotdet_tpu_torch/tools/test_net.py",
                 "oneshotdet_tpu_torch/utils/checkpoint.py",
                 "oneshotdet_tpu_torch/utils/model_zoo.py",
                 "oneshotdet_tpu_torch/utils/c2_import.py",
                 "oneshotdet_tpu_torch/data/paths_catalog.py",
                 "oneshotdet_tpu_torch/tools/train_net.py",
                 "oneshotdet_tpu_torch/tools/remove_solver_states.py",
                 "oneshotdet_tpu_torch/export.py", "oneshotdet_tpu_torch/ops/library.py",
                 "oneshotdet_tpu_torch/tools/export_model.py",
                 "oneshotdet_tpu_torch/tools/oneshot_demo.py",
                 "oneshotdet_tpu_torch/structures/segmentation_mask.py",
                 "oneshotdet_tpu_torch/data/transforms.py",
                 "oneshotdet_tpu_torch/models/mask_head.py",
                 "oneshotdet_tpu_torch/models/keypoint_head.py",
                 "oneshotdet_tpu_torch/models/roi_heads.py",
                 "oneshotdet_tpu_torch/structures/keypoint.py",
                 "oneshotdet_tpu_torch/ops/quant.py",
                 "oneshotdet_tpu_torch/tools/quant_drift.py"):
        assert path in names


@pytest.mark.parametrize("module", ["structures/segmentation_mask.py", "data/transforms.py",
                                    "data/datasets/coco.py", "models/mask_head.py",
                                    "data/evaluation/coco_eval.py", "structures/keypoint.py"])
def test_support_mask_and_jitter_never_import_pil(module):
    """The polygon fill, the colour jitter and the mask paste-back are
    numpy: PIL is imported by none of these modules, not even inside a
    function (the port reads PIL only to decode a non-PPM image, in
    ``data/image_io.py``, and to draw boxes and text in ``predictor.py``)."""
    tree = ast.parse((ROOT / "oneshotdet_tpu_torch" / module).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert not any(n == "PIL" or n.startswith("PIL.") for n in names), node.lineno


def test_forbidden_name_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("oneshotdet_tpu") and _forbidden("oneshotdet_tpu.ops.nms")
    assert not _forbidden("oneshotdet_tpu_torch") and not _forbidden("oneshotdet_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"
