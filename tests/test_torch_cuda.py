"""The CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA card and skip without one; run them on the H100
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.  They import
only PyTorch and the port, so they run where JAX is not installed."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cikm2020_dmt_torch.core.config import TransformerConfig  # noqa: E402
from cikm2020_dmt_torch.nn.transformer import transformer_init  # noqa: E402
from cikm2020_dmt_torch.ops import block  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest -m cuda "
                    "tests/test_torch_cuda.py` on the H100")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [10, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(T_, dtype, cuda_device):
    """The CUDA kernel against the plain version on the card, lens 0..T."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    p = transformer_init(gen, TransformerConfig(maxlen_k=T_))
    B = 301
    enc = torch.randn(B, T_, 80, generator=gen, device=cuda_device).to(dt)
    dec = torch.randn(B, 80, generator=gen, device=cuda_device).to(dt)
    lens = torch.arange(B, device=cuda_device) % (T_ + 1)
    mask = (torch.arange(T_, device=cuda_device)[None] < lens[:, None]
            ).float()
    kw = dict(enc_in=enc, dec_in=dec, seq_mask=mask, num_heads=4)
    got = block.fused_encode_decode(p["enc"][0], p["dec"][0], **kw)
    want = block.fused_encode_decode_ref(p["enc"][0], p["dec"][0], **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
