"""Input data: the playlist file pipelines and their TFRecord format, the
GloVe co-occurrence pipelines with their record files and proto3 codec,
host prefetch, and the vocabularies (counterpart of
``esrecsys_tpu/data``)."""
