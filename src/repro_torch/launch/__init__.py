"""Launchers of the port (torch twin of ``repro.launch``).

``train``  ``python -m repro_torch.launch.train``: the production training
           launcher on one card (``repro.launch.train``'s twin).
           ``mesh``, ``specs``, ``dryrun``, ``dryrun_amg`` and ``roofline``
           are not ported yet.
"""
