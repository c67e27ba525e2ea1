"""Composite network helpers (reference python/paddle/fluid/nets.py):
simple_img_conv_pool, img_conv_group, sequence_conv_pool, glu and
scaled_dot_product_attention, as in the JAX package."""

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "scaled_dot_product_attention",
    "img_conv_group",
    "sequence_conv_pool",
    "glu",
]


def simple_img_conv_pool(
    input,
    num_filters,
    filter_size,
    pool_size,
    pool_stride,
    pool_padding=0,
    pool_type="max",
    global_pooling=False,
    conv_stride=1,
    conv_padding=0,
    conv_dilation=1,
    conv_groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    use_cudnn=True,
):
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=conv_stride,
        padding=conv_padding,
        dilation=conv_dilation,
        groups=conv_groups,
        param_attr=param_attr,
        bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(
    input,
    conv_num_filter,
    pool_size,
    conv_padding=1,
    conv_filter_size=3,
    conv_act=None,
    param_attr=None,
    conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0,
    pool_stride=1,
    pool_type="max",
    use_cudnn=True,
):
    tmp = input
    if not isinstance(conv_padding, list):
        conv_padding = [conv_padding] * len(conv_num_filter)
    if not isinstance(conv_filter_size, list):
        conv_filter_size = [conv_filter_size] * len(conv_num_filter)
    if not isinstance(conv_with_batchnorm, list):
        conv_with_batchnorm = [conv_with_batchnorm] * len(conv_num_filter)
    if not isinstance(conv_batchnorm_drop_rate, list):
        conv_batchnorm_drop_rate = [conv_batchnorm_drop_rate] * len(conv_num_filter)
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not conv_with_batchnorm[i] else None
        tmp = layers.conv2d(
            input=tmp,
            num_filters=nf,
            filter_size=conv_filter_size[i],
            padding=conv_padding[i],
            param_attr=param_attr,
            act=local_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i]:
                tmp = layers.dropout(tmp, dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type, pool_stride=pool_stride
    )


def sequence_conv_pool(
    input, num_filters, filter_size, param_attr=None, act="sigmoid", pool_type="max"
):
    conv_out = layers.sequence_conv(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act,
    )
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """reference nets.py scaled_dot_product_attention (3-D q/k/v)."""
    from .models.transformer import multi_head_attention

    d_model = queries.shape[-1]
    return multi_head_attention(
        queries,
        keys,
        values,
        None,
        d_key=d_model // num_heads,
        d_value=values.shape[-1] // num_heads,
        d_model=values.shape[-1],
        n_head=num_heads,
        dropout_rate=dropout_rate,
    )
