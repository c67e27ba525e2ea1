"""Class-based seq2seq decoder API: InitState / StateCell / TrainingDecoder /
BeamSearchDecoder (the torch counterpart of
paddle_tpu/contrib/decoder/beam_search_decoder.py, a Program builder over
the port's layers: DynamicRNN, While, the array ops, beam_search and
beam_search_decode, ops/decode_ops.py).

Reference analog: python/paddle/fluid/contrib/decoder/beam_search_decoder.py
(InitState:43, StateCell:159, TrainingDecoder:384, BeamSearchDecoder:523) —
the user defines per-step state math ONCE in a StateCell updater and reuses
it for teacher-forced training (TrainingDecoder over DynamicRNN) and beam
decode (BeamSearchDecoder over a While loop with beam_search ops).

Dense redesign, as in the JAX package: the reference grows/shrinks LoD
beams dynamically (sequence_expand, lod_reset, early-stop Switch on empty
beams); here beams are DENSE — batch*beam_size rows fixed for the whole decode (the same
padded-dense convention as layers.beam_search / models/machine_translation),
states reordered per step by the beam's parent indices with a gather. The
decode loop is one While with static shapes (bounded by max_len; its
condition is read on the host, so its block runs op by op on the card,
executor.py "open_ended_while"); finished beams ride along
holding end_id (the beam_search op's end_id contract) instead of shrinking
the batch, so there is no early-stop block — the loop runs max_len steps.
"""

import numpy as np

from ... import layers
from ...framework import Variable, default_main_program
from ...param_attr import ParamAttr

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class InitState(object):
    """Initial state of a decoder cell (reference InitState:43): either an
    explicit `init` Variable, or (shape, value, dtype) to be materialized
    against the batch at decode time."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            if shape is None:
                raise ValueError("InitState needs `init` or `shape`")
            self._init = None
            self._shape = list(shape)
            self._value = float(value)
            self._dtype = dtype
        else:
            self._init = init_boot
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder

    def materialize(self, batch_ref):
        """Concrete init tensor: the explicit var, or a batch-shaped fill."""
        if self._init is not None:
            return self._init
        from ...layers.tensor import fill_constant_batch_size_like

        return fill_constant_batch_size_like(
            batch_ref, shape=[-1] + self._shape[1:] if len(self._shape) > 1
            else [-1] + self._shape, dtype=self._dtype, value=self._value,
        )


class StateCell(object):
    """Per-step state machine (reference StateCell:159): `states` maps name →
    InitState, `inputs` maps name → Variable-or-None (None = fed per step),
    the @state_updater function reads inputs/states and set_state()s the new
    values; the enclosing decoder provides where states live."""

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._state_names = list(states)
        self._out_state = out_state
        self._updater = None
        self._cur_states = {}
        self._new_states = {}
        self._cur_inputs = {}

    def state_updater(self, updater):
        self._updater = updater
        return updater

    # -- used inside the updater ------------------------------------------
    def get_input(self, input_name):
        if input_name not in self._cur_inputs:
            raise ValueError("input %r not provided this step" % input_name)
        return self._cur_inputs[input_name]

    def get_state(self, state_name):
        if state_name in self._new_states:
            return self._new_states[state_name]
        if state_name not in self._cur_states:
            raise ValueError("state %r unknown" % state_name)
        return self._cur_states[state_name]

    def set_state(self, state_name, state_value):
        if state_name not in self._init_states:
            raise ValueError("state %r unknown" % state_name)
        self._new_states[state_name] = state_value

    # -- driven by the decoders -------------------------------------------
    def _bind(self, cur_states):
        self._cur_states = dict(cur_states)
        self._new_states = {}

    def compute_state(self, inputs):
        """Run the updater for this step with the given inputs (reference
        StateCell.compute_state:335)."""
        if self._updater is None:
            raise ValueError("no @state_updater registered")
        self._cur_inputs = dict(self._inputs)
        self._cur_inputs.update(inputs)
        self._updater(self)

    def update_states(self):
        """Commit set_state() values into the enclosing decoder's storage."""
        if self._commit is None:
            raise ValueError("update_states() outside a decoder block")
        self._commit(self._new_states)
        self._cur_states.update(self._new_states)
        self._new_states = {}

    def out_state(self):
        return self.get_state(self._out_state)

    _commit = None


class TrainingDecoder(object):
    """Teacher-forced decoding over DynamicRNN (reference TrainingDecoder:384):
    step_input slices the target sequence, the StateCell holds the recurrent
    state as RNN memories, output() collects per-step outputs."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._state_cell = state_cell
        self._status = self.BEFORE_DECODER
        self._drnn = layers.DynamicRNN(name=name)
        self._memories = {}

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._drnn

    def block(self):
        decoder = self

        class _Ctx(object):
            def __enter__(ctx):
                decoder._status = decoder.IN_DECODER
                ctx._inner = decoder._drnn.block()
                ctx._inner.__enter__()
                return ctx

            def __exit__(ctx, *exc):
                out = ctx._inner.__exit__(*exc)
                decoder._status = decoder.AFTER_DECODER
                decoder._state_cell._commit = None
                return out

        return _Ctx()

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        seq_len = None
        len_name = getattr(x, "_len_name", None)
        if len_name is not None:
            seq_len = x.block._var_recursive(len_name)
        inp = self._drnn.step_input(x, seq_len=seq_len)
        # first sequence input pins the batch: materialize state memories
        if not self._memories:
            for name, init in self._state_cell._init_states.items():
                self._memories[name] = self._drnn.memory(
                    init=init.materialize(x)
                )
            self._state_cell._bind(self._memories)

            def commit(new_states):
                for sname, val in new_states.items():
                    self._drnn.update_memory(self._memories[sname], val)
                    self._memories[sname] = val

            self._state_cell._commit = commit
        return inp

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._drnn.static_input(x)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._drnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != self.AFTER_DECODER:
            raise ValueError("call the TrainingDecoder after its block")
        return self._drnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != self.IN_DECODER:
            raise ValueError("%s() must run inside decoder.block()" % method)


class BeamSearchDecoder(object):
    """Beam-search decode over the shared StateCell (reference
    BeamSearchDecoder:523). Dense loop: batch*beam_size rows, states
    gathered by parent index each step; the embedding and output projection
    are created under `name` so training-side parameters can be shared by
    naming them identically."""

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50, sparse_emb=True,
                 max_len=100, beam_size=4, end_id=1, name=None):
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = min(topk_size, target_dict_dim)
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._name = name or "beam_search_decoder"
        self._decoded = None

    @property
    def state_cell(self):
        return self._state_cell

    def _tile_beam(self, x, n):
        batch = n // self._beam_size
        if x.shape[0] is None or x.shape[0] < 0:
            # encoder-side tensors carry a dynamic batch at build time; the
            # decode is static-n, so pin the batch (a no-op slice at runtime)
            x = layers.slice(x, axes=[0], starts=[0], ends=[batch])
        e = layers.unsqueeze(x, [1])
        tiled = layers.expand(e, [1, self._beam_size] + [1] * (len(x.shape) - 1))
        return layers.reshape(tiled, [n] + list(x.shape[1:]))

    def decode(self):
        """Build the decode loop (reference decode:653). Override for a
        custom per-step computation."""
        beam = self._beam_size
        batch = self._init_ids.shape[0]
        if batch is None or batch < 0:
            raise ValueError(
                "BeamSearchDecoder needs a static batch dim on init_ids "
                "(declare the data layer with append_batch_size=False and a "
                "fixed shape) — the dense beam layout is batch*beam_size rows "
                "with static shapes"
            )
        n = batch * beam
        cell = self._state_cell

        # dense beam tiling with the kInitialScore trick: only beam slot 0
        # is live initially, so step 1 expands each batch row into its beams
        pre_ids = self._tile_beam(self._init_ids, n)
        init_score_mask = np.zeros((n, 1), np.float32)
        init_score_mask[np.arange(n) % beam != 0] = -1e9
        pre_scores = layers.elementwise_add(
            self._tile_beam(self._init_scores, n),
            layers.assign(init_score_mask),
        )

        states = {}
        for sname, init in cell._init_states.items():
            states[sname] = layers.assign(
                self._tile_beam(init.materialize(self._init_ids), n)
            )
        static_feeds = {
            k: self._tile_beam(v, n) for k, v in self._input_var_dict.items()
        }

        ids_arr = layers.create_array("int64", shape=[self._max_len, n, 1])
        scores_arr = layers.create_array("float32", shape=[self._max_len, n, 1])
        parents_arr = layers.create_array("int32", shape=[self._max_len, n])

        pre_ids_v = layers.assign(pre_ids)
        pre_scores_v = pre_scores

        i = layers.fill_constant([1], "int64", 0)
        tmax = layers.fill_constant([1], "int64", self._max_len)
        cond = layers.less_than(i, tmax)
        w = layers.While(cond)
        with w.block():
            emb = layers.embedding(
                pre_ids_v,
                size=[self._target_dict_dim, self._word_dim],
                param_attr=ParamAttr(name=self._name + "_trg_emb"),
                is_sparse=False,
            )
            emb = layers.reshape(emb, [n, self._word_dim])
            cell._bind(states)
            new_vals = {}
            cell._commit = new_vals.update
            feeds = {}
            for input_name in cell._inputs:
                feeds[input_name] = static_feeds.get(input_name, emb)
            cell.compute_state(inputs=feeds)
            scores = layers.fc(
                cell.out_state(),
                size=self._target_dict_dim,
                act="softmax",
                param_attr=ParamAttr(name=self._name + "_out_w"),
                bias_attr=ParamAttr(name=self._name + "_out_b"),
            )
            topk_scores, topk_indices = layers.topk(scores, k=self._topk_size)
            accu = layers.elementwise_add(
                layers.log(topk_scores), pre_scores_v, axis=0
            )
            sel_ids, sel_scores, parent = layers.beam_search(
                pre_ids_v, pre_scores_v, topk_indices, accu,
                beam_size=beam, end_id=self._end_id, return_parent_idx=True,
            )
            layers.array_write(sel_ids, i, array=ids_arr)
            layers.array_write(sel_scores, i, array=scores_arr)
            layers.array_write(parent, i, array=parents_arr)
            cell.update_states()
            # write each state's step value back into its loop-carried var,
            # reordered by the beam's parent indices (the dense analog of the
            # reference's sequence_expand beam growth)
            for sname, var in states.items():
                val = new_vals.get(sname, var)
                layers.assign(layers.gather(val, parent), var)
            layers.assign(sel_ids, pre_ids_v)
            layers.assign(sel_scores, pre_scores_v)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(i, tmax, cond=cond)
        cell._commit = None

        self._decoded = layers.beam_search_decode(
            ids_arr, scores_arr, beam_size=beam, end_id=self._end_id,
            parents=parents_arr,
        )

    def __call__(self):
        if self._decoded is None:
            raise ValueError("call decode() before the decoder")
        return self._decoded
