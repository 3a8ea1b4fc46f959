"""Input data: the playlist file pipelines, their TFRecord format, host
prefetch and the uri dictionaries (counterpart of ``esrecsys_tpu/data``)."""
