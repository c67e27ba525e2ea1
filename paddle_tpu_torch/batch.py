"""paddle.batch equivalent (reference python/paddle/batch.py): group a sample
reader into a batch reader."""

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
