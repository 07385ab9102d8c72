"""Language-model scaffold of the port (torch twin of ``repro.models``).

``config``  the architecture zoo's frozen dataclasses (``ModelConfig`` and
            its sub-configs), the LM shape cells (``LM_SHAPES``) and their
            applicability rule; ``repro_torch.configs.<arch>`` instantiate
            them and ``repro_torch.configs.registry`` resolves ``--arch``.
``layers``  norms, RoPE, GQA/MLA attention and their decode forms, the GLU
            FFN, capacity-bounded MoE, Mamba's causal conv and selective
            scan (functional, each under the reference's name).
``transformer``  the stacked decoders and the whisper encoder-decoder:
            ``init_lm``, ``forward_train``, ``decode_step``, the caches,
            ``count_params`` and the ``LM`` module.
``sharding``  the reference's axis env (``attn_strategy``, ``moe_groups``
            decide what is computed; the constraints are the identity on
            one card) and its parameter partition specs as tuples.
"""
