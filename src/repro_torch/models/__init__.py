"""Model substrate of the port: the ``dense`` and ``moe`` decoder LMs of
``repro.models`` in plain torch.

``lm`` assembles GQA or MLA attention (``attention``, ``mla``, ``rope``)
with a SwiGLU/GELU MLP or the MoE layer (``moe``, whose ``sorted``
dispatch runs on the count/rank kernel K1); ``layers`` holds norms, MLPs
and embeddings, ``common`` the init and the layer loop, ``convert`` the
bridge from the JAX package's numpy parameters.  The ``ssm``, ``hybrid``,
``encdec`` and ``vlm`` families wait (ROADMAP.md, Queue 1).
"""
