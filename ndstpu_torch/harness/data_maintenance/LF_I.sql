create or replace temp view iv as
select d_date_sk inv_date_sk,
       i_item_sk inv_item_sk,
       w_warehouse_sk inv_warehouse_sk,
       invn_qty_on_hand inv_quantity_on_hand
from s_inventory
     join warehouse on invn_warehouse_id = w_warehouse_id
     join item on invn_item_id = i_item_id
     join date_dim on cast(invn_date as date) = d_date;

insert into inventory
select inv_date_sk, inv_item_sk, inv_warehouse_sk, inv_quantity_on_hand
from iv;
