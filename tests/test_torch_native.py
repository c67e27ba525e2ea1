"""The port's native C++ host runtime (paddle_tpu_torch/native, built with
g++ into paddle_tpu_torch/_build/): the cases of tests/test_native_runtime.py
— RecordIO round trips, CRC corruption detection, chunk offsets and range
shards, the blocking queue, MultiSlot and gzip parsing — and, across the
two packages, RecordIO files written by one read back by the other record
for record, the reader creators' round trips both ways, and MultiSlot
parses of the same files equal sample for sample."""

import os
import tempfile
import threading
import unittest

import numpy as np

from paddle_tpu import native as jnative
from paddle_tpu_torch import native


class TestRecordIO(unittest.TestCase):
    def test_round_trip_compressed(self):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "data.recordio")
            records = [os.urandom(np.random.randint(1, 2000)) for _ in range(257)]
            with native.RecordIOWriter(path, max_records=50) as w:
                for r in records:
                    w.write(r)
            with native.RecordIOScanner(path) as s:
                got = list(s)
            self.assertEqual(got, records)

    def test_round_trip_uncompressed(self):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "raw.recordio")
            with native.RecordIOWriter(
                path, compressor=native.NO_COMPRESS, max_records=10
            ) as w:
                for i in range(25):
                    w.write(b"rec-%d" % i)
            with native.RecordIOScanner(path) as s:
                self.assertEqual(len(list(s)), 25)

    def test_crc_detects_corruption(self):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "bad.recordio")
            with native.RecordIOWriter(path, max_records=100) as w:
                for i in range(5):
                    w.write(b"x" * 100)
            with open(path, "r+b") as f:
                f.seek(40)  # inside the compressed payload
                f.write(b"\xff\xff\xff")
            with native.RecordIOScanner(path) as s:
                with self.assertRaises(IOError):
                    list(s)

    def test_chunk_offsets_and_range_shard(self):
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "sharded.recordio")
            with native.RecordIOWriter(path, max_records=10) as w:
                for i in range(40):
                    w.write(b"record-%02d" % i)
            offsets = native.chunk_offsets(path)
            self.assertEqual(len(offsets), 4)
            self.assertEqual(offsets[0], 0)
            # shard = chunks 1..2 (start offsets in [offsets[1], offsets[3]))
            with native.RecordIOScanner(path, offsets[1], offsets[3]) as s:
                got = list(s)
            self.assertEqual(got, [b"record-%02d" % i for i in range(10, 30)])


class TestNativeBlockingQueue(unittest.TestCase):
    def test_producer_consumer(self):
        q = native.NativeBlockingQueue(8)
        items = [b"item-%d" % i for i in range(100)]

        def produce():
            for it in items:
                q.push(it)
            q.close()

        t = threading.Thread(target=produce)
        t.start()
        got = []
        while True:
            v = q.pop()
            if v is None:
                break
            got.append(v)
        t.join()
        self.assertEqual(got, items)

    def test_close_unblocks_pop(self):
        q = native.NativeBlockingQueue(2)
        result = []

        def consume():
            result.append(q.pop())

        t = threading.Thread(target=consume)
        t.start()
        q.close()
        t.join(timeout=5)
        self.assertFalse(t.is_alive())
        self.assertEqual(result, [None])

    def test_capacity_bounds(self):
        q = native.NativeBlockingQueue(4)
        for i in range(4):
            q.push(b"x")
        self.assertEqual(q.size(), 4)
        done = []

        def push_fifth():
            q.push(b"y")
            done.append(1)

        t = threading.Thread(target=push_fifth)
        t.start()
        t.join(timeout=0.2)
        self.assertTrue(t.is_alive())  # blocked at capacity
        q.pop()
        t.join(timeout=5)
        self.assertEqual(done, [1])
        q.close()


class TestMultiSlotDataFeed(unittest.TestCase):
    def test_parse_slots(self):
        # reference MultiSlotDataFeed line: per slot "<n> <values...>"
        with tempfile.TemporaryDirectory() as td:
            files = []
            for fi in range(3):
                p = os.path.join(td, "part-%d.txt" % fi)
                with open(p, "w") as f:
                    for li in range(20):
                        sparse = " ".join(str((fi * 20 + li) * 3 + k) for k in range(3))
                        f.write("3 %s 2 0.5 1.5 1 %d\n" % (sparse, fi * 20 + li))
                files.append(p)
            feed = native.MultiSlotDataFeed(
                [native.INT64_SLOT, native.FLOAT32_SLOT, native.INT64_SLOT],
                queue_capacity=16,
            )
            feed.start(files, nthreads=2)
            samples = list(feed)
            self.assertEqual(feed.join(), 0)
            self.assertEqual(len(samples), 60)
            labels = sorted(int(s[2][0]) for s in samples)
            self.assertEqual(labels, list(range(60)))
            for s in samples:
                self.assertEqual(s[0].dtype, np.int64)
                self.assertEqual(list(s[1]), [0.5, 1.5])
                self.assertEqual(int(s[0][1]), int(s[2][0]) * 3 + 1)

    def test_parse_errors_counted(self):
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "bad.txt")
            with open(p, "w") as f:
                f.write("1 42\n")
                f.write("not a number\n")
                f.write("1 43\n")
            feed = native.MultiSlotDataFeed([native.INT64_SLOT])
            feed.start([p], nthreads=1)
            samples = list(feed)
            self.assertEqual(len(samples), 2)
            self.assertEqual(feed.join(), 1)




class TestGzipFeed(unittest.TestCase):
    def test_parses_gzip_shards(self):
        """gzip-transparent input (reference operators/reader/ctr_reader.cc
        reads .gz text shards): same slot format, compressed files."""
        import gzip

        with tempfile.TemporaryDirectory() as td:
            paths = []
            for fi in range(2):
                p = os.path.join(td, "part-%d.txt.gz" % fi)
                with gzip.open(p, "wt") as f:
                    for li in range(15):
                        f.write("1 %d 2 0.25 0.75\n" % (fi * 15 + li))
                paths.append(p)
            feed = native.MultiSlotDataFeed(
                [native.INT64_SLOT, native.FLOAT32_SLOT]
            )
            feed.start(paths, nthreads=2)
            samples = list(feed)
            self.assertEqual(feed.join(), 0)
            self.assertEqual(len(samples), 30)
            self.assertEqual(sorted(int(s[0][0]) for s in samples), list(range(30)))


class TestAcrossPackages(unittest.TestCase):
    def test_library_builds_into_the_port_build_dir(self):
        native.lib()
        built = native._lib_path(" ".join(sum(native._zlib_args()[:2], [])))
        self.assertTrue(os.path.exists(built))
        pkg = os.path.dirname(os.path.dirname(os.path.realpath(native.__file__)))
        self.assertEqual(os.path.realpath(os.path.dirname(built)), os.path.join(pkg, "_build"))

    def test_recordio_written_by_one_reads_in_the_other(self):
        rng = np.random.RandomState(5)
        records = [rng.bytes(int(rng.randint(1, 3000))) for _ in range(211)]
        for writer, reader, comp in ((jnative, native, 1), (native, jnative, 1),
                                     (jnative, native, 0), (native, jnative, 0)):
            with tempfile.TemporaryDirectory() as td:
                path = os.path.join(td, "x.recordio")
                with writer.RecordIOWriter(path, compressor=comp, max_records=37) as w:
                    for r in records:
                        w.write(r)
                with reader.RecordIOScanner(path) as s:
                    self.assertEqual(list(s), records)
                self.assertEqual(native.chunk_offsets(path), jnative.chunk_offsets(path))
                offs = native.chunk_offsets(path)
                with reader.RecordIOScanner(path, offs[2], offs[4]) as s:
                    self.assertEqual(list(s), records[74:148])

    def test_recordio_creators_round_trip_both_ways(self):
        from paddle_tpu.reader import creator as jcreator
        from paddle_tpu_torch.reader import creator

        rng = np.random.RandomState(6)
        samples = [(rng.randn(3).astype("float32"), int(rng.randint(10))) for _ in range(45)]
        for w, r in ((creator, jcreator), (jcreator, creator)):
            with tempfile.TemporaryDirectory() as td:
                files = w.convert_reader_to_recordio_files(
                    os.path.join(td, "d.recordio"), 20, lambda: iter(samples))
                self.assertEqual([os.path.basename(f) for f in files],
                                 ["d-00000.recordio", "d-00001.recordio", "d-00002.recordio"])
                got = list(r.recordio(",".join(files))())
                self.assertEqual(len(got), 45)
                for (a, b), (c, d) in zip(got, samples):
                    np.testing.assert_array_equal(a, c)
                    self.assertEqual(b, d)
                one = os.path.join(td, "one.recordio")
                self.assertEqual(w.convert_reader_to_recordio_file(one, lambda: iter(samples)), 45)
                self.assertEqual(len(list(r.recordio(one)())), 45)

    def test_multislot_parses_equal(self):
        import gzip

        rng = np.random.RandomState(7)
        with tempfile.TemporaryDirectory() as td:
            paths = []
            for fi in range(3):
                p = os.path.join(td, "part-%d.txt" % fi + (".gz" if fi == 2 else ""))
                opener = gzip.open if fi == 2 else open
                with opener(p, "wt") as f:
                    for _ in range(40):
                        n = int(rng.randint(1, 6))
                        ids = " ".join(str(int(v)) for v in rng.randint(0, 1000, n))
                        f.write("%d %s 2 %.4f %.4f 1 %d\n" % (n, ids, rng.rand(), rng.rand(),
                                                              rng.randint(2)))
                paths.append(p)
            slots = [native.INT64_SLOT, native.FLOAT32_SLOT, native.INT64_SLOT]
            out = []
            for mod in (jnative, native):
                feed = mod.MultiSlotDataFeed(slots, queue_capacity=8)
                feed.start(paths, nthreads=1)
                samples = list(feed)
                self.assertEqual(feed.join(), 0)
                out.append(samples)
            self.assertEqual(len(out[0]), 120)
            self.assertEqual(len(out[0]), len(out[1]))
            for a, b in zip(out[0], out[1]):
                for x, y in zip(a, b):
                    self.assertEqual(x.dtype, y.dtype)
                    np.testing.assert_array_equal(x, y)
