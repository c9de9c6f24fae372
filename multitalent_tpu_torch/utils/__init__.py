from multitalent_tpu_torch.utils.fileops import (  # noqa: F401
    load_json,
    load_pickle,
    maybe_mkdir,
    save_json,
    save_pickle,
    subdirs,
    subfiles,
)
