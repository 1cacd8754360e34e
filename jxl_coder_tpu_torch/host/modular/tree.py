"""MA (meta-adaptive) context trees for Modular mode (§H.4).

A tree is a list of nodes decoded breadth-first; decision nodes test a
property against a split value, leaves carry (predictor, offset,
multiplier) and get consecutive entropy-context ids in decode order.

Entropy-context layout (tree decoding itself): 6 contexts —
0 splitval, 1 property, 2 predictor, 3 offset, 4 multiplier-log,
5 multiplier-bits.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..bitstream.reader import BitReader, BitstreamError, unpack_signed, \
    pack_signed
from ..bitstream.writer import BitWriter
from ..entropy.coder import EntropyDecoder, TokenStream

# `property` is also a Node field name; keep the decorator reachable.
_builtin_property = property

CTX_SPLITVAL = 0
CTX_PROPERTY = 1
CTX_PREDICTOR = 2
CTX_OFFSET = 3
CTX_MUL_LOG = 4
CTX_MUL_BITS = 5
NUM_TREE_CONTEXTS = 6

MAX_PREDICTOR = 13


@dataclasses.dataclass
class Node:
    # decision node when property >= 0
    property: int = -1
    splitval: int = 0
    left: int = 0
    right: int = 0
    # leaf payload
    predictor: int = 0
    offset: int = 0
    multiplier: int = 1
    ctx: int = 0  # leaf context id

    @_builtin_property
    def is_leaf(self) -> bool:
        return self.property < 0


class Tree:
    def __init__(self, nodes: List[Node]):
        self.nodes = nodes
        self.num_leaves = sum(1 for n in nodes if n.is_leaf)

    @property
    def max_property(self) -> int:
        return max((n.property for n in self.nodes if not n.is_leaf),
                   default=-1)

    def uses_weighted(self) -> bool:
        # property 15 is the WP max-magnitude error (kWPProp)
        return any(n.is_leaf and n.predictor == 6 for n in self.nodes) or \
            any((not n.is_leaf) and n.property == 15 for n in self.nodes)

    def lookup(self, properties) -> Node:
        node = self.nodes[0]
        while not node.is_leaf:
            if properties[node.property] > node.splitval:
                node = self.nodes[node.left]
            else:
                node = self.nodes[node.right]
        return node

    @staticmethod
    def single_leaf(predictor: int = 5, offset: int = 0,
                    multiplier: int = 1) -> "Tree":
        n = Node(property=-1, predictor=predictor, offset=offset,
                 multiplier=multiplier, ctx=0)
        return Tree([n])


def decode_tree(br: BitReader, size_limit: int) -> Tree:
    dec = EntropyDecoder(br, NUM_TREE_CONTEXTS)
    nodes: List[Node] = []
    to_decode = 1
    leaf_ctx = 0
    while to_decode > 0:
        if len(nodes) > size_limit:
            raise BitstreamError("MA tree too large")
        to_decode -= 1
        prop1 = dec.read(CTX_PROPERTY)
        if prop1 == 0:
            predictor = dec.read(CTX_PREDICTOR)
            if predictor > MAX_PREDICTOR:
                raise BitstreamError("invalid predictor")
            offset = unpack_signed(dec.read(CTX_OFFSET))
            mul_log = dec.read(CTX_MUL_LOG)
            if mul_log >= 31:
                raise BitstreamError("multiplier too large")
            mul_bits = dec.read(CTX_MUL_BITS)
            multiplier = (mul_bits + 1) << mul_log
            nodes.append(Node(property=-1, predictor=predictor,
                              offset=offset, multiplier=multiplier,
                              ctx=leaf_ctx))
            leaf_ctx += 1
        else:
            splitval = unpack_signed(dec.read(CTX_SPLITVAL))
            left = len(nodes) + to_decode + 1
            nodes.append(Node(property=prop1 - 1, splitval=splitval,
                              left=left, right=left + 1))
            to_decode += 2
    if not dec.check_final_state():
        raise BitstreamError("tree ANS checksum failed")
    return Tree(nodes)


def encode_tree(bw: BitWriter, tree: Tree) -> None:
    ts = TokenStream(NUM_TREE_CONTEXTS)
    # BFS serialization matching decode order
    for n in tree.nodes:
        if n.is_leaf:
            ts.add(CTX_PROPERTY, 0)
            ts.add(CTX_PREDICTOR, n.predictor)
            ts.add(CTX_OFFSET, pack_signed(n.offset))
            mul = n.multiplier
            mul_log = (mul & -mul).bit_length() - 1
            while (mul >> mul_log) > (1 << 16):  # keep mul_bits small-ish
                mul_log -= 1
            mul_bits = (mul >> mul_log) - 1
            if (mul_bits + 1) << mul_log != mul:
                raise ValueError("multiplier not representable")
            ts.add(CTX_MUL_LOG, mul_log)
            ts.add(CTX_MUL_BITS, mul_bits)
        else:
            ts.add(CTX_PROPERTY, n.property + 1)
            ts.add(CTX_SPLITVAL, pack_signed(n.splitval))
    ts.write(bw)
