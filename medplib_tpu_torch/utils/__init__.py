"""utils of the medplib_tpu_torch port."""
