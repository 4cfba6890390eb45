"""Model zoo: dense/MoE transformers, Mamba2 SSM, Zamba2 hybrid (the JAX
package's form, and the published form), Whisper encoder-decoder, VLM
backbone — in PyTorch, each an ``nn.Module`` whose
``state_dict`` keys are the JAX package's parameter paths."""

from .api import (build_model, decode_specs, make_synthetic_batch,
                  params_specs, prefill_specs, train_batch_specs)
from .convert import params_from_numpy, params_to_numpy
from .encdec import EncDecLM
from .hybrid import HybridLM
from .ssm_lm import MambaLM
from .transformer import DecoderLM
from .zamba2 import Zamba2LM

__all__ = ["build_model", "DecoderLM", "MambaLM", "HybridLM", "EncDecLM",
           "Zamba2LM",
           "params_specs", "train_batch_specs", "prefill_specs",
           "decode_specs", "make_synthetic_batch", "params_from_numpy",
           "params_to_numpy"]
