"""How far the port's training gradients move when the KPConv outputs move a little.

On the CPU at ``preset_tiny`` (gate 200), one pair: the gradient of the
training loss with respect to every trained parameter, once as computed and
once with each KPConv output multiplied by (1 + eps * N(0, 1)). For each eps
it prints the loss's relative change and, per parameter tensor, the largest
gradient change over the tensor's largest entry (and the Frobenius ratio),
worst tensors first. Leaky-ReLU kinks, max-pool winners and the density
count make the change jump once eps is large enough to flip some of them;
this bounds what a card-vs-CPU gradient comparison can expect, given how far
the card's forward differs from the CPU's.

    python3 tools/grad_sensitivity_port.py [eps ...]     (default 1e-6 1e-5)
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    import numpy as np
    import torch

    import diffreg_tpu_torch.nn.kpfcn as kpfcn
    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate

    epsilons = [float(a) for a in argv] or [1e-6, 1e-5]
    batch, _, _ = synthetic_batch(batch_size=1, n_points=256, seed=3)
    model = DiffusionMatchingModel(with_condition_gate(preset_tiny(2), 200.0), device="cpu",
                                   seed=0)
    inputs = model.draw_train_inputs(batch, torch.Generator().manual_seed(0))
    names, params = zip(*model.named_trained_parameters())
    plain, noise = kpfcn.kpconv_batched, {"eps": 0.0}
    gen = torch.Generator().manual_seed(5)

    def perturbed(*args):
        out = plain(*args)
        return out * (1 + noise["eps"] * torch.randn(out.shape, generator=gen))

    def gradients(eps):
        noise["eps"] = eps
        loss = diffreg_loss(model.train_forward(batch, **inputs), batch, LossConfig())[0]
        return float(loss.detach()), torch.autograd.grad(loss, params, allow_unused=True)

    kpfcn.kpconv_batched = perturbed        # the backbone's KPConv entry, for this run only
    try:
        loss0, grads0 = gradients(0.0)
        for eps in epsilons:
            loss1, grads1 = gradients(eps)
            rows = sorted(((float((a - b).abs().max() / a.abs().max()),
                            float((a - b).norm() / a.norm()), n)
                           for n, a, b in zip(names, grads0, grads1) if a is not None),
                          reverse=True)
            print(f"eps {eps:g}: loss moves {abs(loss1 - loss0) / loss0:.3e}; median tensor "
                  f"{np.median([r[0] for r in rows]):.3e}")
            for max_rel, fro_rel, name in rows[:5]:
                print(f"  {max_rel:.3e} of max, {fro_rel:.3e} Frobenius  {name}")
    finally:
        kpfcn.kpconv_batched = plain
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
