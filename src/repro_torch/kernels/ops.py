"""Public wrappers for the port's kernels, in the model's layout.

A CUDA tensor goes to the hand-written kernel (which launches or raises); a
CPU tensor goes to the kernel's plain version. Shapes that do not satisfy the
reference's tiling predicate go to the plain-torch oracle, exactly as the JAX
package's ``ops`` sends them to its jnp reference.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd


def flash_attention(q, k, v, *, causal=True, bq=256, bk=256):
    """Model layout [B,S,H,D] in/out; GQA via kv-head grouping."""
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    sq, sk = qt.shape[2], kt.shape[2]
    h, hkv = qt.shape[1], kt.shape[1]
    if sq % min(bq, sq) or sk % min(bk, sk) or h % hkv:
        o = ref.attention_ref(qt, kt, vt, causal=causal)
    else:
        o = flash_attention_bhsd(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)
