"""``mfu``'s reading in granite-4.0-h-small's cell, with the routed experts
counted at this card's share: a token runs ``num_experts_per_tok`` x
held / published of its experts here (10 x 18 / 72 = 2.5), and the router
at its published 72 outputs. The slice's closed-form FLOPs over (slice x
the bf16 peak), in %."""
import dataclasses

from flowbench import readers


def card_share(cfg) -> dict:
    published = cfg["published"]["num_local_experts"]
    held = cfg["num_local_experts"]
    return dict(cfg, num_local_experts=published,
                num_experts_per_tok=cfg["num_experts_per_tok"] * held / published)


def read(run):
    if readers.slice_seconds(run) is None or "published" not in run.cfg:
        return None
    cell = dataclasses.replace(run.cell, cfg=card_share(run.cfg))
    return readers.mfu(dataclasses.replace(run, cell=cell))
