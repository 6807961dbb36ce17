"""Model substrate of the port: the six model families of ``repro.models``
in plain torch.

``lm`` assembles GQA or MLA attention (``attention``, ``mla``, ``rope``)
with a SwiGLU/GELU MLP or the MoE layer (``moe``, whose ``sorted``
dispatch runs on the count/rank kernel K1) for the dense, moe and vlm
families, and Mamba2 blocks (``ssm``) for the ssm and hybrid ones;
``encdec`` is the encoder-decoder.  ``layers`` holds norms, MLPs and
embeddings, ``common`` the init, the trees and the layer loop,
``convert`` the bridge from the JAX package's numpy parameters and train
states.  Each family's ``forward`` (the training path) recomputes its
layers in the backward under ``cfg.remat``.
"""
