"""Memory generator — the Mnemosyne analogue (paper refs [36, 37]).

Given a PLM specification (capacity, word width, required parallel ports),
produce a multi-bank memory architecture built from dual-ported SRAM
macros and report its area.  Behavioural fidelity targets (Sections 3.1
and 5.1 of the paper):

  * each SRAM macro provides 2 read/write ports, so ``ports`` parallel
    accesses need ceil(ports/2) macros-worth of banking at minimum, and
    cyclic bank interleaving needs the bank count to be a power of two so
    the selection logic stays negligible;
  * more banks => superlinear area: small macros amortize their sense
    amps/decoders worse (the ``_bank_eff`` factor), plus per-bank muxing;
  * memory takes 40-90% of component area on typical accelerators, which
    the constants below reproduce for the WAMI components.

This module is the ASIC cost model used by ``core.hlsim``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

__all__ = ["PLMSpec", "PLM", "MemGen"]

# 32nm-flavoured SRAM constants (mm^2); see hlsim.py for the calibration note.
_CELL_AREA_MM2_PER_BIT = 3.0e-7      # 6T cell + array periphery (32nm macro)
_MACRO_OVERHEAD_MM2 = 2.6e-3         # decoders, sense amps, BIST per macro
_MUX_AREA_PER_PORT_BANK = 3.0e-5     # bank-select / crossbar slice
_MIN_MACRO_WORDS = 64


@dataclass(frozen=True)
class PLMSpec:
    words: int
    word_bits: int
    ports: int                      # parallel accesses required per cycle


@dataclass(frozen=True)
class PLM:
    banks: int
    words_per_bank: int
    area: float                     # mm^2
    ports: int
    word_bits: int = 32             # macro word width
    clients: int = 1                # components time-multiplexed onto it

    @property
    def bits(self) -> int:
        """Physical storage bits of the generated architecture."""
        return self.banks * self.words_per_bank * self.word_bits

    def total_bits(self, word_bits: int) -> int:
        """Storage bits at an explicit word width (pre-dates the stored
        ``word_bits``; equals ``bits`` when the widths agree)."""
        return self.banks * self.words_per_bank * word_bits


class MemGen:
    """Deterministic multi-bank PLM generator."""

    def generate(self, spec: PLMSpec) -> PLM:
        if spec.words <= 0:
            return PLM(banks=0, words_per_bank=0, area=0.0, ports=spec.ports,
                       word_bits=spec.word_bits)
        # Ports must be servable in one cycle: with dual-ported macros,
        # ceil(ports/2) banks minimum; round banks to a power of two so
        # the bank-select logic avoids Euclidean division (Section 5,
        # ref [46]).
        need = max(1, math.ceil(spec.ports / 2))
        banks = 1 << (need - 1).bit_length()
        words_per_bank = max(_MIN_MACRO_WORDS, math.ceil(spec.words / banks))
        # Efficiency: small macros amortize periphery worse.
        eff = 1.0 + 0.35 * math.log2(banks) if banks > 1 else 1.0
        bits = words_per_bank * spec.word_bits
        area_macros = banks * (_MACRO_OVERHEAD_MM2 + bits * _CELL_AREA_MM2_PER_BIT * eff)
        area_mux = spec.ports * banks * _MUX_AREA_PER_PORT_BANK
        return PLM(banks=banks, words_per_bank=words_per_bank,
                   area=area_macros + area_mux, ports=spec.ports,
                   word_bits=spec.word_bits)

    def generate_shared(self, specs: Sequence[PLMSpec]) -> PLM:
        """One physical PLM serving several *mutually exclusive* clients.

        Only one client accesses the memory at a time (the planner's
        compatibility certificate), so the shared architecture needs the
        envelope of the requirements — max capacity, max word width, max
        port count — not their sum; Mnemosyne's address-space sharing
        (paper refs [36, 37]) exploits exactly this.  Each client beyond
        the first pays an arbitration slice per port-bank pair (the
        client-select crossbar layer in front of the bank mux).
        """
        if not specs:
            raise ValueError("generate_shared needs at least one PLMSpec")
        env = PLMSpec(words=max(s.words for s in specs),
                      word_bits=max(s.word_bits for s in specs),
                      ports=max(s.ports for s in specs))
        plm = self.generate(env)
        arb = ((len(specs) - 1) * env.ports * max(1, plm.banks)
               * _MUX_AREA_PER_PORT_BANK)
        return PLM(banks=plm.banks, words_per_bank=plm.words_per_bank,
                   area=plm.area + arb, ports=plm.ports,
                   word_bits=plm.word_bits, clients=len(specs))
