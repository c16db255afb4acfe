"""PyTorch port, tools/step_parity.DecisionReplay on the CPU: a recording
run computes with the ops themselves and only notes their decisions; a
replaying run takes the recorded decisions and counts where its own
differ. Exact: both are selections, no arithmetic is reordered."""

import torch
import torch.nn.functional as F

from zerospeech_tts_tpu_torch.tools.step_parity import DecisionReplay

torch.set_num_threads(1)


def _x(seed):
    return torch.randn(4, 6, 5, generator=torch.Generator().manual_seed(seed))


def test_recording_computes_with_the_ops_themselves():
    x = _x(0).requires_grad_(True)
    x0 = x.detach().clone().requires_grad_(True)
    with DecisionReplay() as mode:
        y = F.leaky_relu(x, 0.2)
        idx = torch.argmax(x, -1)
        y2 = F.leaky_relu(x, negative_slope=0.3)
    (y.sum() + y2.sum()).backward()
    (F.leaky_relu(x0, 0.2).sum() + F.leaky_relu(x0, negative_slope=0.3).sum()).backward()
    assert torch.equal(y, F.leaky_relu(x0, 0.2)) and torch.equal(y2, F.leaky_relu(x0, 0.3))
    assert torch.equal(idx, torch.argmax(x0, -1))
    assert torch.equal(x.grad, x0.grad)
    assert len(mode.tape) == 3 and mode.flips == mode.decisions == 0


def test_replay_takes_the_recorded_decisions_and_counts_flips():
    x = _x(1)
    with DecisionReplay() as rec:
        F.leaky_relu(x, 0.2)
        x.argmax(-1)
    x2 = x.clone()
    x2[0, 0, :3] = -x2[0, 0, :3]  # three slope decisions flip
    x2[1, 2] = 0.0
    x2[1, 2, 4] = 10.0  # one argmax decision flips, unless it was already 4
    with DecisionReplay(rec.tape) as rep:
        y = F.leaky_relu(x2, negative_slope=0.2)
        idx = x2.argmax(-1)
    mask = x > 0
    assert torch.equal(y, torch.where(mask, x2, 0.2 * x2))
    assert torch.equal(idx, x.argmax(-1))
    want = int(((x2 > 0) != mask).sum()) + int((x2.argmax(-1) != x.argmax(-1)).sum())
    assert rep.flips == want >= 3
    assert rep.decisions == x.numel() + x.shape[0] * x.shape[1]
