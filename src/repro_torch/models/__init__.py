"""Language-model scaffold of the port (torch twin of ``repro.models``).

``config``  the architecture zoo's frozen dataclasses (``ModelConfig`` and
            its sub-configs), the LM shape cells (``LM_SHAPES``) and their
            applicability rule; ``repro_torch.configs.<arch>`` instantiate
            them and ``repro_torch.configs.registry`` resolves ``--arch``.
"""
