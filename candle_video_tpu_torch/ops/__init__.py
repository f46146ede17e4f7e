from .activations import gelu_tanh, silu
from .attention import attention, attention_xla
from .embeddings import sinusoidal_timestep_embedding
from .norms import layer_norm, rms_norm
from .rope import apply_rotary_emb, rope_cos_sin

__all__ = [
    "gelu_tanh",
    "silu",
    "attention",
    "attention_xla",
    "sinusoidal_timestep_embedding",
    "layer_norm",
    "rms_norm",
    "apply_rotary_emb",
    "rope_cos_sin",
]
