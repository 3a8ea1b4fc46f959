"""Dataset ETL (counterpart of ``esrecsys_tpu/etl``)."""
