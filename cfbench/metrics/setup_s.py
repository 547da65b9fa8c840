"""Set-up seconds: process start to the first timed request (imports,
kernel load from the in-checkout build cache, data synthesis, the
server or the first build, warm-up)."""
def read(records):
    return records.get("setup_s")
