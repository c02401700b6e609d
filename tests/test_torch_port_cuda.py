"""The port's CUDA and Triton kernel wrappers on the card: they reject
inputs the kernels cannot take, and the serving step launches each kernel
the expected number of times. The kernels' outputs are held against their
plain versions by ``chip_smoke.py``. Every test here needs a CUDA card and
skips without one.

The module imports no jax, so it runs where jax is absent; tests/conftest.py
imports jax, so run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import pytest
import torch

from efficientdet_tpu_torch import DetectorConfig, EfficientDet, make_eval_step
from efficientdet_tpu_torch.kernels import fusion
from efficientdet_tpu_torch.kernels.nms_kernel import nms_select

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_rejects_bad_input(cuda):
    scores = torch.rand(2, 10, device=cuda)
    boxes = torch.rand(2, 10, 4, device=cuda)
    with pytest.raises(TypeError):
        nms_select(scores.double(), boxes, 0.5, 5)
    with pytest.raises(ValueError, match="contiguous"):
        nms_select(scores, boxes.transpose(0, 1).contiguous().transpose(0, 1),
                   0.5, 5)
    with pytest.raises(ValueError, match="shapes"):
        nms_select(scores, boxes[:, :9], 0.5, 5)


def test_fusion_kernels_reject_non_channels_last(cuda):
    big = torch.rand(1, 8, 4, 4, device=cuda)  # NCHW-contiguous
    small = torch.rand(1, 8, 2, 2, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        fusion.fuse_topdown(big, small, torch.tensor([0.5, 0.5], device=cuda))


def test_small_serving_step_launches_kernels(cuda):
    """The small detector's serving step on the card, fusion on: one NMS
    launch and 7 fusion launches (4 top-down, 3 bottom-up) per step."""
    cfg = DetectorConfig(num_classes=4, network="efficientdet-d0",
                         input_size=128, W_bifpn=16, D_bifpn=1, D_class=1,
                         head_stacked_convs=1, head_feat_channels=16)
    model = EfficientDet(cfg, dtype=torch.bfloat16, use_fusion_kernels=True,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    model = model.eval().to(memory_format=torch.channels_last)
    counts = (nms_select.launches, fusion.fuse_topdown.launches,
              fusion.fuse_bottomup.launches)
    det = make_eval_step(model, cfg)(torch.randint(
        0, 256, (2, 128, 128, 3), dtype=torch.uint8, device=cuda))
    torch.cuda.synchronize()
    assert (nms_select.launches - counts[0], fusion.fuse_topdown.launches
            - counts[1], fusion.fuse_bottomup.launches - counts[2]) == (1, 4, 3)
    assert det.scores.shape == (2, 100)
    assert torch.isfinite(det.boxes).all()
