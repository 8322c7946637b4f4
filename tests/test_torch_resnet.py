"""The port's ResNet against the JAX package's, weights carried across with
``resnet_state_from_jax_params``: global features on both routes (plain
convs, and identity runs through ``fused_stage``), the grouping of identity
runs, and the torchvision state_dict import."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import resnet as JR
from image_caption_tpu_torch.utils.weights import resnet_state_from_jax_params
from image_caption_tpu_torch.vision import resnet as TR

from test_torch_yolov5 import assert_same_tree


@pytest.fixture(scope="module")
def nets():
    out = {}
    for stages in ((1, 1, 1, 1), (2, 2)):
        jp = JR.init_resnet(jax.random.PRNGKey(len(stages)), stages=stages)
        out[stages] = (jp, resnet_state_from_jax_params(jp))
    return out


def _images(seed, n=2, size=64):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (2, 2)])
def test_features_match_jax_f32(stages, use_kernel, nets):
    jp, tp = nets[stages]
    x = _images(0)
    want = np.asarray(JR.resnet_features_jit(jp, jnp.asarray(x)))
    got = TR.resnet_features(tp, torch.from_numpy(x), use_kernel=use_kernel)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_features_match_jax_bf16(use_kernel, nets):
    """bf16 compute: the plain route is the JAX route's arithmetic; the
    kernel route's f32 epilogues round elsewhere.  3e-2 x max|ref|."""
    jp, tp = nets[(2, 2)]
    x = _images(1)
    want = np.asarray(JR.resnet_features_jit(jp, jnp.asarray(x),
                                             compute_dtype=jnp.bfloat16))
    got = TR.resnet_features(tp, torch.from_numpy(x),
                             compute_dtype=torch.bfloat16,
                             use_kernel=use_kernel).numpy()
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_identity_runs_of_resnet101_go_through_one_call_each(monkeypatch):
    """ResNet-101's identity runs are 2, 3, 22 and 2 blocks: with
    use_kernel each is one fused_stage call; the first block of each stage
    (strided or downsampling) takes the plain route either way."""
    layers = [[({"downsample": {}} if b == 0 else {}) for b in range(n)]
              for n in TR.RESNET101_STAGES]
    params = {"stem": {"conv": None, "bn": None}, "layers": layers}
    runs, plain = [], []
    monkeypatch.setattr(TR, "_conv", lambda x, w, stride=1, padding=0: x)
    monkeypatch.setattr(TR, "_bn", lambda x, p: x)
    monkeypatch.setattr(TR, "_bottleneck",
                        lambda p, x, stride: plain.append(stride) or x)
    monkeypatch.setattr(TR, "stack_identity_blocks", lambda run: (len(run),))
    monkeypatch.setattr(TR, "fused_stage", lambda x, n: runs.append(n) or x)
    x = torch.zeros(1, 16, 16, 3)
    TR.resnet_features(params, x, use_kernel=True)
    assert runs == [2, 3, 22, 2] and plain == [1, 2, 2, 2]
    runs.clear(), plain.clear()
    TR.resnet_features(params, x, use_kernel=False)
    assert runs == [] and len(plain) == sum(TR.RESNET101_STAGES)


def torchvision_state_dict(stages, seed=0):
    """A random torchvision resnet state_dict for ``stages``."""
    rng = np.random.RandomState(seed)
    sd = {}

    def bn(pre, c):
        sd[f"{pre}.weight"] = (rng.rand(c) + 0.5).astype(np.float32)
        sd[f"{pre}.bias"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{pre}.running_mean"] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f"{pre}.running_var"] = (rng.rand(c) + 0.5).astype(np.float32)

    def conv(name, co, ci, k):
        sd[name] = (rng.randn(co, ci, k, k) * np.sqrt(2.0 / (k * k * ci))
                    ).astype(np.float32)

    conv("conv1.weight", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, n in enumerate(stages):
        width = 64 * 2 ** i
        for b in range(n):
            pre = f"layer{i + 1}.{b}"
            c_in = cin if b == 0 else width * 4
            conv(f"{pre}.conv1.weight", width, c_in, 1)
            conv(f"{pre}.conv2.weight", width, width, 3)
            conv(f"{pre}.conv3.weight", width * 4, width, 1)
            for j, c in ((1, width), (2, width), (3, width * 4)):
                bn(f"{pre}.bn{j}", c)
            if b == 0:
                conv(f"{pre}.downsample.0.weight", width * 4, c_in, 1)
                bn(f"{pre}.downsample.1", width * 4)
        cin = width * 4
    return sd


@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (2, 2)])
def test_import_state_dict_matches_jax(stages):
    sd = torchvision_state_dict(stages, seed=len(stages))
    want = resnet_state_from_jax_params(JR.import_torch_state_dict(sd, stages))
    got = TR.import_torch_state_dict(sd)          # stages read from the keys
    assert_same_tree(got, want)
    scale = sd["bn1.weight"] / np.sqrt(sd["bn1.running_var"] + TR.BN_EPS)
    np.testing.assert_allclose(got["stem"]["bn"]["scale"].numpy(), scale,
                               rtol=1e-6)
    assert_same_tree(TR.import_torch_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, stages), want)


def test_load_checkpoint_npz_and_pth(tmp_path):
    sd = torchvision_state_dict((1, 1, 1, 1), seed=7)
    np.savez(tmp_path / "r.npz", **sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "r.pth")
    want = resnet_state_from_jax_params(JR.load_torch_checkpoint(
        str(tmp_path / "r.npz"), stages=(1, 1, 1, 1)))
    assert_same_tree(TR.load_torch_checkpoint(str(tmp_path / "r.npz")), want)
    assert_same_tree(TR.load_torch_checkpoint(str(tmp_path / "r.pth")), want)


def test_init_matches_the_jax_shapes():
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: tuple(x.shape), t)
    for stages in ((1, 1, 1, 1), (2, 3)):
        want = resnet_state_from_jax_params(
            JR.init_resnet(jax.random.PRNGKey(0), stages=stages))
        assert shapes(TR.init_resnet(stages=stages)) == shapes(want)
