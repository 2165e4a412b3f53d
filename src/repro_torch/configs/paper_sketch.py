"""The paper's own sketch configurations (§3.2) as a registered 'arch'.

Counterpart of `repro/configs/paper_sketch.py`: CMS-CU (32-bit linear),
CMLS16-CU (b = 1.00025, 16-bit) and CMLS8-CU (b = 1.08, 8-bit) at depth
2, over byte budgets swept around the paper's ideal perfect count storage
(233k distinct elements * 4 B, about 932 kB).
"""
import dataclasses

from repro_torch.configs.registry import Arch, register
from repro_torch.core.counters import CMLS8, CMLS16, CMS32
from repro_torch.core.sketch import SketchSpec


@dataclasses.dataclass(frozen=True)
class PaperSketchConfig:
    variants = {"CMS-CU": CMS32, "CMLS16-CU": CMLS16, "CMLS8-CU": CMLS8}
    depth: int = 2                       # paper Fig. 3 uses 2 levels
    perfect_storage_bytes: int = 233_000 * 4
    # from deep high pressure (32 kB) to about 4x perfect storage
    budgets = (32_768, 65_536, 131_072, 262_144, 524_288,
               1_048_576, 2_097_152, 4_194_304)

    def spec(self, variant: str, budget: int,
             packed: bool = False) -> SketchSpec:
        return SketchSpec.from_memory(budget, depth=self.depth,
                                      counter=self.variants[variant],
                                      packed=packed)


CFG = PaperSketchConfig()

register(Arch(
    name="paper-sketch", family="paper", cfg=CFG, smoke_cfg=CFG, shapes={},
    notes="the paper's three evaluated sketch variants",
))
