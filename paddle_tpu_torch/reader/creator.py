"""Reader creators over concrete storage (reference
python/paddle/reader/creator.py): np_array and text_file. The JAX package's
recordio creator and its converters read and write native RecordIO chunks
(paddle_tpu/native); they come with the native runtime."""

__all__ = ["np_array", "text_file"]


def np_array(x):
    """Yield rows of a numpy array (reference creator.py:np_array)."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Yield lines without the trailing newline (creator.py:text_file)."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader
