"""Reader creators over concrete storage (reference
python/paddle/reader/creator.py: np_array, text_file, recordio) plus the
RecordIO converter (reference python/paddle/fluid/recordio_writer.py +
benchmark/fluid/recordio_converter.py). Records are pickled sample tuples in
native RecordIO chunks (paddle_tpu_torch/native — C++ scanner/writer, CRC +
compression), so a converted dataset feeds training without re-running the
Python preprocessing chain. The files are the JAX package's: either package
reads what the other wrote."""

import pickle

from .. import native

__all__ = [
    "np_array",
    "text_file",
    "recordio",
    "convert_reader_to_recordio_file",
    "convert_reader_to_recordio_files",
]


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


def recordio(paths, begin=0, end=-1):
    """Yield unpickled samples from native RecordIO file(s); `begin`/`end`
    byte-range shards a single file across trainers (chunk-granular, the Go
    master's task model — native.chunk_offsets gives the cut points)."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        for path in paths:
            with native.RecordIOScanner(path, begin, end) as s:
                for rec in s:
                    yield pickle.loads(rec)

    return reader


def convert_reader_to_recordio_file(
    filename,
    reader_creator,
    compressor=native.ZLIB,
    max_num_records=1000,
):
    """Serialize every sample of a reader into one RecordIO file; returns the
    record count (reference recordio_writer.py:convert_reader_to_recordio_file)."""
    count = 0
    with native.RecordIOWriter(
        filename, compressor=compressor, max_records=max_num_records
    ) as w:
        for sample in reader_creator():
            w.write(pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL))
            count += 1
    return count


def convert_reader_to_recordio_files(
    filename,
    batch_per_file,
    reader_creator,
    compressor=native.ZLIB,
    max_num_records=1000,
):
    """Spill a reader into multiple suffixed RecordIO files of
    `batch_per_file` records each (recordio_writer.py:72) — the unit the
    distributed master dispatches."""
    f_name, f_ext = (filename.rsplit(".", 1) + [""])[:2]
    lines = []
    files = []
    idx = 0
    for sample in reader_creator():
        lines.append(sample)
        if len(lines) == batch_per_file:
            path = "%s-%05d%s" % (f_name, idx, "." + f_ext if f_ext else "")
            convert_reader_to_recordio_file(
                path, np_array(lines), compressor, max_num_records
            )
            files.append(path)
            idx += 1
            lines = []
    if lines:
        path = "%s-%05d%s" % (f_name, idx, "." + f_ext if f_ext else "")
        convert_reader_to_recordio_file(
            path, np_array(lines), compressor, max_num_records
        )
        files.append(path)
    return files
