"""Stacked dynamic-LSTM text model (a copy of paddle_tpu/models/stacked_lstm.py;
BASELINE config 5, structural parity with
reference benchmark/fluid/models/stacked_dynamic_lstm.py: embedding → per
layer [fc(4h) → dynamic_lstm] → max-pool both streams → fc softmax)."""

from .. import layers


def stacked_lstm_net(
    words, label, dict_dim, emb_dim=128, hid_dim=128, stacked_num=3, class_num=2
):
    emb = layers.embedding(words, size=[dict_dim, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4)
    lstm1, cell1 = layers.dynamic_lstm(fc1, size=hid_dim * 4)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(inputs, size=hid_dim * 4)
        lstm, cell = layers.dynamic_lstm(fc, size=hid_dim * 4)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max")
    logits = layers.fc([fc_last, lstm_last], size=class_num)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return loss, acc, logits
