"""Launchers of the port (torch twin of ``repro.launch``).

``train``       ``python -m repro_torch.launch.train``: the production
                training launcher on one card (``repro.launch.train``'s
                twin).
``mesh``        the production meshes (16x16, 2x16x16), the one-card
                mesh ``card`` and the AMG rank mesh, as descriptions.
``specs``       every (arch x shape x mesh) cell's inputs as fake tensors
                with their sanitized spec tuples and per-device bytes.
``dryrun``      ``python -m repro_torch.launch.dryrun``: each cell's step
                traced on the meta device (FLOPs, bytes, per-device
                memory), and on the ``card`` mesh run for real where it
                fits; ``--amg`` runs ``dryrun_amg``.
``dryrun_amg``  the distributed AMG solve staged for 256 and 512 ranks,
                and run at world size 1 on the card.
``roofline``    ``python -m repro_torch.launch.roofline``: the records
                against one H100's peaks.
"""
