"""Train and serve step builders of the port (torch twin of
``repro.train``).

``steps``  ``make_prefill``, ``make_serve_step`` and ``make_init``: the
           serving half of ``repro.train.steps``.  ``cross_entropy``,
           ``loss_fn``, ``make_train_step``, the optimizer, data,
           checkpoint and fault modules are not ported yet.
"""
