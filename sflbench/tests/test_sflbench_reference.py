"""The plain reference against the port at a small width on the CPU:
one fp32 run of checked steps, one int8 run with a migration inside
them, and the Mamba-2 cell; the reference codec bit for bit against the
port's; the reference's SSD against its own token-by-token recurrence."""
import pytest
import torch

from conftest import tiny_cell
from harness import check, program, session, spec
from reference import codec, model as ref_model

CASES = {  # cell: what it covers
    "granite8b-4l.sflga-fp32-s1024": "fp32 steps at a fixed cut",
    "granite8b-4l.sflga-int8-cutmig-s1024": "int8 both ways, cut 2 -> 1",
    "mamba2-130m.sflga-fp32-b2-s1024": "the SSD mixer",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_follows_the_port(name):
    c = tiny_cell(spec.cell(name))
    su = session.setup(c, 2 ** 31 + 77, "cpu")
    ref = session.reference_readings(c, 2 ** 31 + 77, "cpu")
    nums = check.numbers(su.checked, ref)
    # float32 on both sides, summed in other orders: a few ulps of the
    # loss, and the norms' gaps at round-off
    assert nums["loss_gap"] < 1e-6, nums
    assert nums["grad_gap"] < 1e-4, nums
    assert nums["change_gap"] < 1e-4, nums
    assert len(su.checked["losses"]) == session.CHECKED


def test_int8_cell_migrates_inside_the_checked_steps():
    c = spec.cell("granite8b-4l.sflga-int8-cutmig-s1024")
    cuts = session.checked_inputs(tiny_cell(c), 1, "cpu")[2]
    assert cuts[0] != cuts[-1]


def test_codec_bit_for_bit():
    program.import_program()
    from repro_torch.compress import get_codec
    from repro_torch.compress.channel import (client_seeds, downlink_seed,
                                              uplink_channel)

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 2, 40, 64, generator=g) * 3
    seed = 2 ** 32 - 5
    port = uplink_channel(get_codec("int8"), x, seed)
    ours = torch.stack([codec.roundtrip(x[n], codec.uplink_seed(seed, n))
                        for n in range(3)])
    assert torch.equal(port, ours)
    assert [codec.uplink_seed(seed, n) for n in range(3)] == \
        client_seeds(seed, 3).tolist()
    assert codec.downlink_seed(seed) == downlink_seed(seed)
    one = get_codec("int8").roundtrip(x[0], downlink_seed(seed))
    assert torch.equal(one, codec.roundtrip(x[0], codec.downlink_seed(seed)))


def test_ssd_against_the_recurrence():
    g = torch.Generator().manual_seed(1)
    b, S, H, P, N = 2, 48, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.2
    A = -torch.rand(H, generator=g) * 2
    Bm = torch.randn(b, S, 1, N, generator=g)
    Cm = torch.randn(b, S, 1, N, generator=g)
    y = ref_model.ssd(x, dt, A, Bm, Cm, 16)
    h = torch.zeros(b, H, P, N)
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", x[:, t] * dt[:, t, :, None], Bm[:, t, 0])
        want = torch.einsum("bhpn,bn->bhp", h, Cm[:, t, 0])
        assert torch.allclose(y[:, t], want, atol=1e-5, rtol=1e-5)
