"""The control of a cell's comparison: the plain reference computed in
float32, put in the engine's place, judged as a run judges the engine,
over the statements each client's sequence starts with."""
from __future__ import annotations

import itertools
from typing import Dict, Optional

from . import compare, spec, traffic

#: statements of each client's sequence judged (about what a window
#: sends: a run of the agg cell completes 20-30 a client)
STATEMENTS = 32


def control_readings(cell: spec.Cell, seed: int, device: str,
                     overrides: Optional[Dict] = None) -> Dict:
    import torch
    cfg = {**cell.config, **(overrides or {})}
    insts = {}
    for c in range(int(cell.traffic["clients"])):
        for inst in itertools.islice(
                traffic.sequence(cfg["suite"], cell.traffic, seed, c),
                STATEMENTS):
            insts.setdefault(inst.key, inst)
    data = spec.reference_tables(cfg["suite"]).Data(cfg["scale_factor"],
                                                    device)
    worst, mismatched = 0.0, 0
    per_template: Dict[str, float] = {}
    for inst in insts.values():
        ref = spec.reference(cfg["suite"], inst.template)
        want = ref.answer(data, inst.params, torch.float64)
        low = ref.answer(data, inst.params, torch.float32)
        v = compare.judge(low, want, ref.ORDER_BY)
        worst = max(worst, v.gap)
        mismatched += not v.matched
        per_template[inst.template] = max(per_template.get(inst.template, 0.0),
                                          v.gap)
    data.free()
    return {"max_rel_gap": worst, "mismatched_statements": mismatched,
            "instances": len(insts),
            "max_rel_gap_by_template": per_template,
            "limit": cfg["compare"]["max_rel_gap"]}
