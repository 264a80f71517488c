"""Plain CPU arguments for each function that ``repro_torch.launch.per_device``
stands in for during a dry-run count, shared by ``test_torch_dryrun.py``
and the subprocess it starts."""

import torch

from repro_torch.train.optimizer import OptimizerConfig


def plain_calls():
    """Plain CPU arguments of each rule's original: {name: (module, fn name,
    args, kwargs)}, made from one seed."""
    from repro_torch.models import attention, layers, moe, ssm
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    x, tok = r(2, 6, 16), torch.randint(0, 50, (2, 6), generator=g)
    params = {"w": r(8, 16), "b": r(16)}
    cfg = OptimizerConfig(total_steps=4)
    return {
        "project_heads": (layers, "project_heads", (x, r(16, 4, 8)), {}),
        "project_out": (attention, "project_out",
                        ({"wo": r(4, 8, 16), "bo": r(16)}, r(2, 6, 4, 8)), {}),
        "embed": (layers, "embed", ({"embedding": r(50, 16)}, tok,
                                    torch.float32), {}),
        "unembed": (layers, "unembed", ({"embedding": r(50, 16)}, x), {}),
        "output_head": (layers, "output_head", ({"w_out": r(16, 50)}, x), {}),
        "logz_and_target": (layers, "logz_and_target", (r(2, 6, 50), tok),
                            {}),
        "sequence_attention": (attention, "sequence_attention",
                               (r(2, 6, 4, 8), r(2, 6, 2, 8), r(2, 6, 2, 8)),
                               {"causal": True, "train": True}),
        "_decode": (attention, "_decode", (r(2, 1, 4, 16), r(2, 6, 2, 16),
                                           r(2, 6, 2, 16), 4), {}),
        "moe_apply": (moe, "moe_apply", (init_params(moe.moe_spec(16, 8, 4),
                                                     g, torch.float32,
                                                     device="cpu"), x),
                      {"top_k": 2, "train": True}),
        "_mlstm_scan": (ssm, "_mlstm_scan", (r(2, 6, 2, 4), (
            r(2, 6, 2, 4), r(2, 6, 2, 4), -r(2, 6, 2).abs(), r(2, 6, 2)),
            (None, None), 4), {}),
        "_slstm_scan": (ssm, "_slstm_scan", (r(2, 5, 32), r(2, 4, 16)), {}),
        "adamw_update": (optimizer, "adamw_update", (
            {"w": r(8, 16), "b": r(16)}, optimizer.adamw_init(params, cfg),
            params, cfg), {}),
    }
