"""write_ms.dump: host ms a volume in the HDF5 stand-in's
create_dataset, the zlib deflate included (traced run)."""


def read(run):
    return run.counters.get("write_ms_per_volume")
