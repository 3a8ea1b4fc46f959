"""Row-sharded tables and partition rules over the ``(data, model)`` grid
(counterpart of ``esrecsys_tpu/parallel``)."""
