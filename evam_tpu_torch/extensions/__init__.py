"""Built-in UDF extensions (counterpart of ``evam_tpu/extensions``): the
reference's spatial-analytics extensions, zone count, line crossing and
event convert, which ``stages/udf.py`` resolves pipeline module names
onto."""
